#!/usr/bin/env python3
"""Data parallelism of the PyTorch port (``concepthash_tpu_torch``) across
the GPUs of one host, against one GPU. From the root of the repository:

    python3 scripts/multi_gpu_check_torch.py --nproc 4
    python3 scripts/multi_gpu_check_torch.py --nproc 4 --device cpu

It builds the subblock-mins kernel once (on the card), then starts
``--nproc`` ranks with ``python -m torch.distributed.run --standalone``
(NCCL on the card, one GPU a rank; gloo with ``--device cpu``, at a tiny
size). Each rank checks, on its own device:

1. the sharded top-k: a seeded gallery of ``W`` x 2^20 64-bit codes (2^14
   on the CPU), each rank holding its block, through
   ``make_sharded_topk(exact=True)`` (kernel 2 on each card): its
   distances equal ``retrieve_topk``'s over the whole gallery on this
   rank's device bit for bit, and its indices are distinct and score
   their distances (on the card the subblock selection of
   ``exact_topk_minspass`` orders ties its own way in the shards and in
   the whole gallery, so the indices of tied rows may differ); both
   timed;
2. the flagship (ViT-B/32, adapters 384, 64 bits, 200 classes, bf16,
   dropout 0.1) under sgd at a global batch of 32 a rank: 3 steps on W
   ranks against 3 one-device steps of the whole batch from the same
   state: each loss within ``TRAIN_LOSS_RTOL`` and the update's cosine
   over every trained tensor at least ``MIN_UPDATE_COSINE`` (the ranks
   sum in another order and round in bf16; adam's first updates are the
   gradients' signs, which a rounding turns over where a gradient is
   near zero, so the steps take sgd as phase 22 (a) of chip_smoke.py
   does); every rank holds the same parameters bit for bit; then, under
   the config's adam, a warm-up chunk and a replayed chunk of 2 steps
   with the collectives captured in a CUDA graph against as many eager
   W-rank steps, bit for bit; the eager step's ms on W ranks beside one
   device's at the whole batch, alternated.

Rank 0 prints the results, the card's name and power limit, and one JSON
line; a failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the CPU run's tiny model and gallery (the card runs chip_smoke's sizes)
CPU_SIZES = dict(vision=dict(hidden_size=64, intermediate_size=128,
                             num_layers=2, num_heads=4, image_size=32,
                             patch_size=8, projection_dim=32),
                 head=dict(nbit=64, nclass=10, ncontext=4, center_dim=32,
                           text_projection_dims=(32,)),
                 bottleneck=32, images=8, image_side=40, train_batch=4,
                 k=10, reps=2)
CPU_GALLERY = 1 << 14
CARD_GALLERY = 1 << 20
STEPS = 3


def fail(msg: str) -> None:
    raise RuntimeError(f"multi-GPU check failed: {msg}")


def wall_ms(fn, reps: int, device) -> float:
    """Mean wall ms of ``fn`` after one warm-up, ending in a device
    synchronize on the card."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def sharded_topk(cs, sizes, mesh, device, gallery_per_rank: int) -> dict:
    from concepthash_tpu_torch.ops.retrieval import retrieve_topk
    from concepthash_tpu_torch.ops.sharded import (make_sharded_topk,
                                                   shard_gallery)

    nbit, k = sizes.head["nbit"], sizes.k
    n = gallery_per_rank * mesh.size
    gen = torch.Generator(device=device).manual_seed(0)
    gallery = torch.randint(0, 2, (n, nbit), generator=gen, device=device,
                            dtype=torch.int8) * 2 - 1
    codes = torch.randn(sizes.images, nbit, generator=gen, device=device)
    with torch.inference_mode():
        shard, _ = shard_gallery(gallery, mesh)
        fn = make_sharded_topk(mesh, k, exact=True, n_valid=n)
        d, idx = fn(codes, shard)
        d_one, i_one = retrieve_topk(codes, gallery, k=k, exact=True)
        q = (codes > 0).float() * 2 - 1
        scored = 0.5 * (nbit - (q[:, None, :] * gallery[idx].float()).sum(-1))
        distinct = all(len(set(row)) == k for row in idx.tolist())
        same = (torch.equal(d, d_one) and torch.equal(scored, d)
                and distinct)
        tie_moved = int((idx != i_one).sum())
        sharded_ms = wall_ms(lambda: fn(codes, shard), sizes.reps, device)
        one_ms = wall_ms(lambda: retrieve_topk(codes, gallery, k=k,
                                               exact=True),
                         sizes.reps, device)
    if not same:
        fail(f"rank {mesh.rank}: the sharded top-k's distances differ from "
             "retrieve_topk's over the whole gallery, or its indices do not "
             "score them")
    return {"codes": n, "queries": sizes.images, "k": k,
            "equal": same, "tied_indices_moved": tie_moved,
            "sharded_ms": sharded_ms, "one_device_ms": one_ms}


def flat_update(model, before: dict) -> torch.Tensor:
    return torch.cat([(p.detach().float() - before[n]).reshape(-1)
                      for n, p in model.named_parameters()
                      if p.requires_grad])


def train_steps(cs, sizes, mesh, device) -> dict:
    import torch.distributed as dist

    from concepthash_tpu_torch.methods import build_training
    from concepthash_tpu_torch.parallel.mesh import shard_batch
    from concepthash_tpu_torch.train.state import make_multi_train_step

    W = mesh.size
    per_rank = sizes.train_batch
    big = dataclasses.replace(sizes, train_batch=per_rank * W)
    cfg = cs.train_config(big)
    centers = cs.flagship_centers(sizes)
    spe = sizes.steps_per_epoch
    dp, one = (build_training(dict(cfg, optim=dict(cs.SGD_OPTIM)), centers,
                              spe, device=device, mesh=m)
               for m in (mesh, None))
    one.model.load_state_dict(dp.model.state_dict())
    vcfg = dp.model.vision_cfg
    before = {n: p.detach().float().clone()
              for n, p in dp.model.named_parameters() if p.requires_grad}
    losses = []
    batches = [cs.flagship_batch(big, vcfg, big.train_batch, device, 80 + i)
               for i in range(STEPS)]
    for b in batches:
        got = float(dp.step(shard_batch(b, mesh))["loss"])
        want = float(one.step(b)["loss"])
        losses.append((got, want))
    u_dp, u_one = flat_update(dp.model, before), flat_update(one.model,
                                                             before)
    cosine = float(torch.nn.functional.cosine_similarity(u_dp, u_one, dim=0))
    rel = max(abs(g - w) / abs(w) for g, w in losses)
    # every rank holds the same parameters
    flat = torch.cat([p.detach().float().reshape(-1)
                      for p in dp.model.parameters()])
    first = flat.clone()
    dist.broadcast(first, src=0, group=mesh.group)
    replicas_equal = torch.equal(flat, first)
    if rel > cs.TRAIN_LOSS_RTOL or cosine < cs.MIN_UPDATE_COSINE or \
            not replicas_equal:
        fail(f"rank {mesh.rank}: {W}-rank steps against one device: loss "
             f"rel {rel}, update cosine {cosine}, replicas equal "
             f"{replicas_equal}")

    # a graphed chunk against eager steps, both on W ranks
    csizes = dataclasses.replace(cs.check_sizes(sizes), train_batch=per_rank)
    graph, eager = (build_training(cfg, centers, spe, device=device,
                                   mesh=mesh) for _ in range(2))
    eager.model.load_state_dict(graph.model.state_dict())
    chunk_batches, stacked = cs.stacked_batches(
        dataclasses.replace(csizes, train_batch=per_rank * W), vcfg,
        sizes.head["nclass"], 2, device, 90)
    multi = make_multi_train_step(graph.model, graph.loss_fn, graph.optimizer,
                                  graph.scheduler, generator=graph.generator,
                                  mesh=mesh)
    local = [{k: v[:, mesh.rows(per_rank)] for k, v in c.items()}
             for c in stacked]
    g_loss = [x for c in local for x in multi(c)["loss"].tolist()]
    e_loss = [float(eager.step(shard_batch(b, mesh))["loss"])
              for b in chunk_batches]
    gs, es = graph.model.state_dict(), eager.model.state_dict()
    d = max((gs[k].float() - es[k].float()).abs().max().item() for k in gs)
    replays = multi.replays if device.type == "cuda" else 0
    graph_ok = g_loss == e_loss and d == 0.0
    if not graph_ok or (device.type == "cuda" and replays < 1):
        fail(f"rank {mesh.rank}: the graphed chunk on {W} ranks differs "
             f"from eager steps (parameters max |d| {d}) or was not "
             "replayed")
    del graph, eager, multi

    # the eager step's ms: W ranks at per_rank each, one device at W x
    b = batches[0]
    local_b = shard_batch(b, mesh)
    times = {"ranks": [], "one": []}
    for name in ("one", "ranks", "ranks", "one"):
        if name == "ranks":
            times[name].append(wall_ms(lambda: dp.step(local_b), 3, device))
        else:
            # the one-device step on every rank at once: each card alone
            times[name].append(wall_ms(lambda: one.step(b), 3, device))
        dist.barrier(group=mesh.group)
    return {"global_batch": per_rank * W, "losses": losses,
            "update_cosine": cosine, "replicas_equal": replicas_equal,
            "graph_bit_for_bit": graph_ok, "replays": replays,
            "step_ms_ranks": times["ranks"], "step_ms_one": times["one"]}


def worker(args) -> int:
    import chip_smoke as cs
    from concepthash_tpu_torch.parallel.mesh import (init_distributed,
                                                     make_mesh, shutdown)

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if not init_distributed(device):
        fail("no process group: run through torch.distributed.run")
    try:
        mesh = make_mesh()
        device = mesh.device
        sizes = (cs.Sizes() if device.type == "cuda"
                 else cs.Sizes(**CPU_SIZES))
        t0 = time.perf_counter()
        topk = sharded_topk(cs, sizes, mesh, device,
                            CARD_GALLERY if device.type == "cuda"
                            else CPU_GALLERY)
        train = train_steps(cs, sizes, mesh, device)
        secs = time.perf_counter() - t0
        if mesh.rank == 0:
            card = cs.card_line() if device.type == "cuda" else "the CPU"
            print(f"sharded top-{topk['k']} over {topk['codes']} codes on "
                  f"{mesh.size} ranks ({mesh.backend}): distances equal "
                  f"retrieve_topk's over the whole gallery bit for bit, "
                  f"indices distinct and scoring them: {topk['equal']} "
                  f"({topk['tied_indices_moved']} indices of tied rows "
                  f"placed otherwise); {topk['sharded_ms']:.3f} ms beside "
                  f"one device's {topk['one_device_ms']:.3f} ms; {card}")
            print(f"flagship steps at a global batch of "
                  f"{train['global_batch']} on {mesh.size} ranks against one "
                  f"device: losses " + ", ".join(
                      f"{g:.5f} / {w:.5f}" for g, w in train["losses"])
                  + f", update cosine {train['update_cosine']:.6f}, "
                  f"replicas equal {train['replicas_equal']}; graphed chunk "
                  f"bit for bit {train['graph_bit_for_bit']} with "
                  f"{train['replays']} replays; eager ms a step on "
                  f"{mesh.size} ranks {train['step_ms_ranks']}, on one "
                  f"device at the whole batch {train['step_ms_one']}; {card}")
            print(f"multi-GPU check: {secs:.1f} s")
            print(json.dumps({"ranks": mesh.size, "backend": mesh.backend,
                              "device": (torch.cuda.get_device_name(device)
                                         if device.type == "cuda" else "cpu"),
                              "topk": topk, "train": train}))
    finally:
        shutdown()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args)
    if args.device == "cuda":
        if torch.cuda.device_count() < args.nproc:
            print(f"multi-GPU check: {args.nproc} ranks need as many GPUs, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        from concepthash_tpu_torch import _build

        _build.build(("topk_select",))      # once, before the ranks load it
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={args.nproc}", os.path.abspath(__file__),
           "--worker", "--device", args.device]
    return subprocess.run(cmd, cwd=ROOT).returncode


if __name__ == "__main__":
    sys.exit(main())

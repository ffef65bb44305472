#!/usr/bin/env python3
"""Convert a reference (torch) trained model checkpoint into a run directory
of the PyTorch port (``concepthash_tpu_torch``).

The reference saves ``model.state_dict()`` at ``<logdir>/models/*.pth``.
This tool maps those weights onto the port's model for the SAME method and
config (backbone geometry, nbit, nclass and adapter widths must match the
run that wrote the checkpoint; ``utils/torch_import.py``) and writes a run
directory, ``config.yaml`` and ``models/best.pt``, which the port's
eval-only and finetune flows read. The arguments are those of
``scripts/import_reference_checkpoint.py``; config overrides use
``main_gpu.py``'s syntax:

  python3 scripts/import_reference_checkpoint_torch.py \\
      --pth /path/to/ref_run/models/best.pth --outdir runs/imported \\
      model=orthohash_adapter backbone=resnet50 model.nbit=64 \\
      dataset=cub200 ...

Then evaluate or finetune:
  python3 main_gpu.py exp=validation logdir=runs/imported
  python3 main_gpu.py ... finetune_path=runs/imported

The model is built on the CPU; nothing here needs the card.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pth", required=True, help="reference models/*.pth")
    ap.add_argument("--outdir", required=True,
                    help="output run dir (gets config.yaml + models/best.pt)")
    ap.add_argument("--unsafe", action="store_true",
                    help="allow full-unpickler torch.load for legacy blobs "
                         "that fail weights_only=True (arbitrary code "
                         "execution risk — trusted checkpoints only)")
    ap.add_argument("overrides", nargs="*",
                    help="config overrides (main_gpu.py syntax)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from concepthash_tpu_torch.config.loader import load_config, save_config
    from concepthash_tpu_torch.experiments.hashing import \
        offline_text_embedder
    from concepthash_tpu_torch.methods import (build_model, get_method,
                                               prepare_codebook)
    from concepthash_tpu_torch.models.backbone_factory import \
        vision_config_from_backbone_cfg
    from concepthash_tpu_torch.utils import io
    from concepthash_tpu_torch.utils.torch_import import (
        import_reference_state_dict, load_state_dict)

    config_dir = os.environ.get("CONCEPTHASH_CONFIG_DIR",
                                os.path.join(REPO, "configs"))
    workdir = os.path.abspath(args.outdir)
    cfg = load_config(config_dir, "train",
                      list(args.overrides) + [f"logdir={workdir}"])
    method = get_method(cfg["model"]["name"])
    os.makedirs(os.path.join(workdir, "models"), exist_ok=True)
    codebook = None
    if method.codebook:
        try:
            codebook = prepare_codebook(method, cfg, workdir, device="cpu")
        except Exception as e:
            # the experiment's offline fallback; the checkpoint's trained
            # center replaces the codebook-derived one anyway
            logging.warning("codebook stage failed (%s); offline fallback", e)
            dim = int(cfg["model"].get("center_dim", 0) or
                      vision_config_from_backbone_cfg(
                          cfg.get("backbone", {}) or {}).projection_dim)
            codebook = prepare_codebook(
                method, cfg, workdir,
                text_embedder=lambda n: offline_text_embedder(n, dim=dim))
    model, _ = build_model(cfg, codebook, device="cpu")

    sd = load_state_dict(args.pth, unsafe=args.unsafe)
    state, report = import_reference_state_dict(sd, cfg["model"]["name"],
                                                cfg, model)
    logging.info("mapped %d tensors; %d unused checkpoint keys",
                 len(report.written), len(report.unused))
    if report.missing:
        print("EXPECTED tensors the checkpoint had no value for (these stay "
              "at random init — the imported model is likely WRONG):")
        for k in report.missing:
            print(" ", k)
    out_ckpt = os.path.join(workdir, "models", "best.pt")
    io.fast_save({"model": state, "epoch": 0}, out_ckpt)
    io.join_save_queue()
    save_config(cfg, os.path.join(workdir, "config.yaml"))
    print(f"wrote {out_ckpt} ({len(report.written)} tensors imported, "
          f"{len(report.unused)} reference keys unmapped); evaluate with: "
          f"python3 main_gpu.py exp=validation logdir={workdir}")
    if report.unused:
        print("unmapped keys (variant knobs this importer doesn't cover):")
        for k in report.unused[:20]:
            print(" ", k)
    return {"report": report, "config": cfg, "model": model}


if __name__ == "__main__":
    main()

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX's CPU mesh.)
"""

import numpy as np
import pytest
import torch

import concepthash_tpu_torch.ops.attention as tat
import concepthash_tpu_torch.ops.fused_layer as tfl
import concepthash_tpu_torch.ops.fused_ln as tln
import concepthash_tpu_torch.ops.topk_select as tts

B, L, D, H, F, A = 2, 21, 64, 4, 128, 32   # L = 16 patches + cls + 4 concepts


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.fixture
def np_rng():
    return np.random.default_rng(7)


def _weights(rng, cls, shapes, device, dtype):
    """cls(**random tensors); matrices in ``dtype``, vectors f32."""
    t = {k: torch.tensor((rng.standard_normal(s) * 0.1).astype(np.float32))
         for k, s in shapes.items()}
    for k in t:
        if k.startswith("ln") and k.endswith("scale"):
            t[k] = t[k] + 1.0
    return cls(**{k: v.to(device) for k, v in t.items()}).cast(dtype)


def _layer(rng, device, dtype=torch.bfloat16):
    return _weights(rng, tfl.LayerWeights, dict(
        ln1_scale=(D,), ln1_bias=(D,), w_qkv=(3 * D, D), b_qkv=(3 * D,),
        w_out=(D, D), b_out=(D,), ln2_scale=(D,), ln2_bias=(D,),
        w_fc1=(F, D), b_fc1=(F,), w_fc2=(D, F), b_fc2=(D,)), device, dtype)


def _adapter(rng, device, dtype=torch.bfloat16):
    return _weights(rng, tfl.AdapterWeights, dict(
        ln_scale=(D,), ln_bias=(D,), w_down=(A, D), b_down=(A,),
        w_up=(D, A), b_up=(D,), scale=(1,)), device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("adapters", ["none", "attn", "mlp", "both"])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_layer_kernel_matches_plain(np_rng, cuda_device, adapters, act):
    """bf16 kernel vs the plain version: |d| <= 0.05 + 0.02|ref| (a few bf16
    ulps: both round at the same points, but their f32 sums run in another
    order, so an intermediate can round to the neighbouring bf16 value)."""
    w = _layer(np_rng, cuda_device)
    a1 = _adapter(np_rng, cuda_device) if adapters in ("attn", "both") else None
    a2 = _adapter(np_rng, cuda_device) if adapters in ("mlp", "both") else None
    x = torch.tensor(np_rng.standard_normal((B, L, D)).astype(np.float32),
                     device=cuda_device).to(torch.bfloat16)
    kw = dict(num_heads=H, act=act, adapter_attn=a1, adapter_mlp=a2)
    before = tfl.encoder_layer_cuda.launches
    got = tfl.encoder_layer(x, w, **kw)
    torch.cuda.synchronize()
    assert tfl.encoder_layer_cuda.launches == before + 1
    want = tfl.layer_reference(x, w, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0.02,
                               atol=0.05)


def _wide_weights(rng, cls, shapes, device):
    """cls(**random tensors) at a real width: matrices with std
    1/sqrt(fan_in) in bf16, LayerNorm scales near 1, small vectors f32."""
    t = {}
    for k, s in shapes.items():
        v = rng.standard_normal(s).astype(np.float32)
        if len(s) == 2:
            v = v / np.sqrt(s[1])
        elif k.endswith("scale") and k != "scale":
            v = 1.0 + 0.1 * v
        elif k != "scale":
            v = 0.02 * v
        else:
            v = np.ones(s, np.float32)
        t[k] = torch.tensor(v).to(device)
    return cls(**t).cast(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,length", [(5, 54), (3, 197)])
@pytest.mark.parametrize("adapters", ["none", "both"])
def test_layer_kernel_matches_plain_at_vit_width(np_rng, cuda_device, batch,
                                                 length, adapters):
    """The layer kernel at ViT width (D=768, F=3072, 12 heads, adapters of
    384) against its plain version: B*L not a multiple of the GEMM's
    128-row tile (5 x 54 = 270), and ViT-B/16's length 197, whose attention
    rows span four 64-key chunks. Same tolerance as the small shapes."""
    Dw, Fw, Hw, Aw = 768, 3072, 12, 384
    w = _wide_weights(np_rng, tfl.LayerWeights, dict(
        ln1_scale=(Dw,), ln1_bias=(Dw,), w_qkv=(3 * Dw, Dw),
        b_qkv=(3 * Dw,), w_out=(Dw, Dw), b_out=(Dw,), ln2_scale=(Dw,),
        ln2_bias=(Dw,), w_fc1=(Fw, Dw), b_fc1=(Fw,), w_fc2=(Dw, Fw),
        b_fc2=(Dw,)), cuda_device)
    ads = [None, None]
    if adapters == "both":
        ads = [_wide_weights(np_rng, tfl.AdapterWeights, dict(
            ln_scale=(Dw,), ln_bias=(Dw,), w_down=(Aw, Dw), b_down=(Aw,),
            w_up=(Dw, Aw), b_up=(Dw,), scale=(1,)), cuda_device)
            for _ in range(2)]
    x = torch.tensor(np_rng.standard_normal((batch, length, Dw)).astype(
        np.float32), device=cuda_device).to(torch.bfloat16)
    kw = dict(num_heads=Hw, adapter_attn=ads[0], adapter_mlp=ads[1])
    before = tfl.encoder_layer_cuda.launches
    got = tfl.encoder_layer(x, w, **kw)
    torch.cuda.synchronize()
    assert tfl.encoder_layer_cuda.launches == before + 1
    want = tfl.layer_reference(x, w, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0.02,
                               atol=0.05)


@pytest.mark.cuda
def test_layer_kernel_rejects_bad_inputs(np_rng, cuda_device):
    w = _layer(np_rng, cuda_device)
    x = torch.zeros((B, L, D), dtype=torch.float32, device=cuda_device)
    with pytest.raises(TypeError):
        tfl.encoder_layer_cuda(x, w, num_heads=H)
    with pytest.raises(ValueError):
        tfl.encoder_layer_cuda(x.to(torch.bfloat16), w, num_heads=H,
                               act="relu")


@pytest.mark.cuda
@pytest.mark.parametrize("nbit,N", [(16, 5003), (32, 70_001), (64, 100_003),
                                    (128, 4097)])
def test_mins_kernel_matches_plain(cuda_device, nbit, N):
    """The CUDA kernel equals its plain version element for element, in the
    serving layout ((Q, m_pad) mins, the pad columns up to m_pad at
    nbit + 1, and the (Q, m_pad / 64) superblock mins): a ragged N, m two
    past the last real subblock, the packed and the plain layout, 1, 100
    and 1,024 queries, S = 8, 64, 128 and 256, both dtypes."""
    g = torch.Generator(device=cuda_device).manual_seed(nbit)
    db = tts.strict_signs(torch.randint(0, 2, (N, nbit), generator=g,
                                        device=cuda_device))
    packed, n_pad = tts.pack_serving_gallery(db)
    for Q in (1, 100, 1024):
        qi = tts.strict_signs(torch.randint(0, 2, (Q, nbit), generator=g,
                                            device=cuda_device))
        for gal, n_codes in ((db, N), (packed, n_pad)):
            for S in (8, 64, 128, 256):
                m_real = -(-n_codes // S)
                m = m_real + 2
                for dt in (torch.bfloat16, torch.float32):
                    before = tts.subblock_mins_cuda.launches
                    got, got_sb = tts.subblock_mins_cuda(
                        qi, gal, n_codes, S, m, dt, superblocks=True)
                    torch.cuda.synchronize()
                    assert tts.subblock_mins_cuda.launches == before + 1
                    want, want_sb = tts._mins_reference_serving(
                        qi, gal.reshape(n_codes, nbit), S, m, dt,
                        superblocks=True)
                    assert got.shape == (Q, -(-m // 64) * 64)
                    torch.testing.assert_close(got, want, atol=0, rtol=0)
                    torch.testing.assert_close(got_sb, want_sb, atol=0,
                                               rtol=0)
                    assert (got[:, m_real:] == nbit + 1).all()
                    alone, none = tts.subblock_mins_cuda(qi, gal, n_codes, S,
                                                         m, dt)
                    assert none is None and torch.equal(alone, got)


@pytest.mark.cuda
def test_mins_kernel_counts_its_layouts(cuda_device):
    """``.plain_launches`` counts the launches over the plain (N, nbit)
    layout, and the reference's (m, Q) views read the kernel's output."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    db = tts.strict_signs(torch.randint(0, 2, (4096, 64), generator=g,
                                        device=cuda_device))
    q = torch.randint(0, 2, (10, 64), generator=g, device=cuda_device)
    packed, _ = tts.pack_serving_gallery(db)
    n, p = tts.subblock_mins_cuda.launches, tts.subblock_mins_cuda.plain_launches
    a = tts.subblock_min_dists(q, db)
    b = tts.subblock_min_dists_packed(q, packed)
    assert tts.subblock_mins_cuda.launches == n + 2
    assert tts.subblock_mins_cuda.plain_launches == p + 1
    assert a.shape == b.shape == (64, 10) and torch.equal(a, b)


@pytest.mark.cuda
def test_mins_kernel_rejects_bad_inputs(cuda_device):
    qi = torch.ones((4, 64), dtype=torch.int8, device=cuda_device)
    db = torch.ones((1024, 64), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):                          # S % 8
        tts.subblock_mins_cuda(qi, db, 1024, 12, 86)
    with pytest.raises(ValueError):                          # nbit
        tts.subblock_mins_cuda(qi[:, :24].contiguous(),
                               db[:, :24].contiguous(), 1024, 64, 16)
    with pytest.raises(TypeError):
        tts.subblock_mins_cuda(qi.float(), db, 1024, 64, 16)
    with pytest.raises(TypeError):
        tts.subblock_mins_cuda(qi, db, 1024, 64, 16, torch.float16)
    with pytest.raises(ValueError):                          # m too small
        tts.subblock_mins_cuda(qi, db, 1024, 64, 15)
    with pytest.raises(ValueError):                          # byte count
        tts.subblock_mins_cuda(qi, db, 1000, 64, 16)
    with pytest.raises(ValueError):                          # not aligned
        tts.subblock_mins_cuda(qi, db.view(-1)[8:8 + 1023 * 64].view(
            1023, 64), 1023, 64, 16)
    with pytest.raises(ValueError):                          # device
        tts.subblock_mins_cuda(qi.cpu(), db, 1024, 64, 16)


@pytest.mark.cuda
def test_minspass_hierarchical_on_card_matches_cpu(cuda_device, monkeypatch):
    """The hierarchical selection reads the kernel's superblock mins: the
    card's exact_topk_minspass equals the CPU's on both layouts."""
    monkeypatch.setattr(tts, "_INNER_DIRECT_MAX", 64)
    rng = np.random.default_rng(9)
    nbit, N, Q = 64, 70_000, 50
    db = np.where(rng.random((N, nbit)) < 0.5, -1, 1).astype(np.int8)
    q = np.where(rng.random((Q, nbit)) < 0.5, -1, 1).astype(np.float32)
    for gal in (torch.tensor(db), tts.pack_serving_gallery(
            torch.tensor(db))[0]):
        want = tts.exact_topk_minspass(torch.tensor(q), gal, 20, cap=64)
        got = tts.exact_topk_minspass(torch.tensor(q, device=cuda_device),
                                      gal.to(cuda_device), 20, cap=64)
        torch.testing.assert_close(got[0].cpu(), want[0], atol=0, rtol=0)
        torch.testing.assert_close(got[1].cpu(), want[1], atol=0, rtol=0)
        assert got[2] == want[2]


@pytest.mark.cuda
def test_packed_mins_and_minspass_match_cpu(cuda_device):
    """The packed-gallery mins and exact_topk_minspass on the card equal the
    same calls on the CPU (plain versions): distances, indices, certificate."""
    rng = np.random.default_rng(3)
    nbit, N, Q = 64, 70_000, 50
    db = np.where(rng.random((N, nbit)) < 0.5, -1, 1).astype(np.float32)
    q = np.where(rng.random((Q, nbit)) < 0.5, -1, 1).astype(np.float32)
    q[:, :2] = 0.0                                       # zeros count as -1
    packed, n_pad = tts.pack_serving_gallery(torch.tensor(db))
    bits = tts.pack_bits_serving(packed, nbit)
    cpu = tts.subblock_min_dists_packed(torch.tensor(q), packed,
                                        out_dtype=torch.bfloat16)
    gpu = tts.subblock_min_dists_packed(torch.tensor(q, device=cuda_device),
                                        packed.to(cuda_device),
                                        out_dtype=torch.bfloat16)
    torch.testing.assert_close(gpu.cpu(), cpu, atol=0, rtol=0)
    for kw in (dict(cap=64), dict(cap=64, db_bits=bits, n_valid=N - 5)):
        want = tts.exact_topk_minspass(torch.tensor(q), packed, 20, **kw)
        kw_gpu = {k: (v.to(cuda_device) if torch.is_tensor(v) else v)
                  for k, v in kw.items()}
        got = tts.exact_topk_minspass(torch.tensor(q, device=cuda_device),
                                      packed.to(cuda_device), 20, **kw_gpu)
        torch.testing.assert_close(got[0].cpu(), want[0], atol=0, rtol=0)
        torch.testing.assert_close(got[1].cpu(), want[1], atol=0, rtol=0)
        assert got[2] == want[2]


@pytest.mark.cuda
@pytest.mark.parametrize("nbit,G", [(16, 301), (32, 1003), (64, 6251),
                                    (128, 517)])
def test_bitplane_mins_kernel_matches_plain(cuda_device, nbit, G):
    """The bit-plane kernel equals its plain version element for element, in
    the serving layout: (Q, m_pad) mins and (Q, m_pad / 64) superblock mins,
    random byte rows, n_rows cutting into the last subblocks, m two past
    the stored codes' subblocks and the pad columns up to m_pad at
    nbit + 1, at S = 8P and at a larger subblock, both dtypes."""
    P = 128 // nbit
    g = torch.Generator(device=cuda_device).manual_seed(nbit)
    bp = torch.randint(0, 256, (G, 128), generator=g, device=cuda_device,
                       dtype=torch.uint8)
    qi = tts.strict_signs(torch.randint(0, 2, (300, nbit), generator=g,
                                        device=cuda_device))
    for S in (8 * P, 128):
        m_real = -(-G * 8 * P // S)
        m = m_real + 2
        for n_rows in (G * 8, G * 8 - 13):
            for dt in (torch.bfloat16, torch.float32):
                before = tts.subblock_mins_bitplane_cuda.launches
                got, got_sb = tts.subblock_mins_bitplane_cuda(
                    qi, bp, n_rows, S, m, dt, superblocks=True)
                torch.cuda.synchronize()
                assert tts.subblock_mins_bitplane_cuda.launches == before + 1
                want, want_sb = tts._bitplane_mins_reference(
                    qi, bp, n_rows, S, m, dt, superblocks=True)
                assert got.shape == (300, -(-m // 64) * 64)
                torch.testing.assert_close(got, want, atol=0, rtol=0)
                torch.testing.assert_close(got_sb, want_sb, atol=0, rtol=0)
                assert (got[:, m_real:] == nbit + 1).all()
                alone, none = tts.subblock_mins_bitplane_cuda(qi, bp, n_rows,
                                                              S, m, dt)
                assert none is None and torch.equal(alone, got)


@pytest.mark.cuda
@pytest.mark.parametrize("inner_direct_max", [32768, 8])
def test_exact_topk_bitplane_matches_cpu(cuda_device, monkeypatch,
                                         inner_direct_max):
    """exact_topk_bitplane on the card (the kernel) equals the same call on
    the CPU (plain versions), on the direct and the hierarchical selection,
    with pad codes masked by n_valid: distances, indices, certificate."""
    monkeypatch.setattr(tts, "_INNER_DIRECT_MAX", inner_direct_max)
    rng = np.random.default_rng(5)
    nbit, N, Q = 64, 70_001, 40
    db = np.where(rng.random((N, nbit)) < 0.5, -1, 1).astype(np.float32)
    q = np.where(rng.random((Q, nbit)) < 0.5, -1, 1).astype(np.float32)
    q[:, :2] = 0.0                                       # zeros count as -1
    bp, n_pad = tts.pack_bitplane_serving(torch.tensor(db))
    assert n_pad > N
    for kw in (dict(cap=64, n_valid=N), dict(cap=8, n_valid=N - 1000)):
        want = tts.exact_topk_bitplane(torch.tensor(q), bp, 20, **kw)
        got = tts.exact_topk_bitplane(torch.tensor(q, device=cuda_device),
                                      bp.to(cuda_device), 20, **kw)
        torch.testing.assert_close(got[0].cpu(), want[0], atol=0, rtol=0)
        torch.testing.assert_close(got[1].cpu(), want[1], atol=0, rtol=0)
        assert got[2] == want[2]


@pytest.mark.cuda
def test_approx_serving_on_card_matches_cpu(cuda_device):
    """exact=False on the card (bf16 sign products + torch.topk) against the
    CPU's stable selection, over a tie-heavy gallery with pad rows: the
    same distances; the card's indices score them and stay below n_valid."""
    from concepthash_tpu_torch.ops import hamming as th
    from concepthash_tpu_torch.ops import retrieval as tr

    rng = np.random.default_rng(9)
    nbit, N, Q, k = 64, 80_000, 33, 50
    base = np.where(rng.random((40, nbit)) < 0.5, -1, 1).astype(np.float32)
    db = base[rng.integers(0, 40, N)]
    q = np.where(rng.random((Q, nbit)) < 0.5, -1, 1).astype(np.float32)
    q[:, :3] = 0.0
    dist = tr.sign_distances(torch.tensor(q), torch.tensor(db)).numpy()
    packed, n_pad = tts.pack_serving_gallery(torch.tensor(db))
    for nv in (None, N - 77):
        calls = (
            lambda t, d: tr.retrieve_topk(t, d, k=k, n_valid=nv),
            lambda t, d: tr.retrieve_topk(t, th.pack_bits(d), k=k,
                                          method="popcount", n_valid=nv),
            lambda t, d: tr.retrieve_topk_streaming(
                t, d.reshape(-1, 128).to(torch.int8), k=k, db_block=20_000,
                n_valid=nv))
        for call in calls:
            want_d, _ = call(torch.tensor(q), torch.tensor(db))
            got_d, got_i = call(torch.tensor(q, device=cuda_device),
                                torch.tensor(db, device=cuda_device))
            torch.testing.assert_close(got_d.cpu(), want_d, atol=0, rtol=0)
            got_i = got_i.cpu().numpy()
            np.testing.assert_array_equal(
                np.take_along_axis(dist, got_i, 1), got_d.cpu().numpy())
            assert got_i.max() < (nv or N)


@pytest.mark.cuda
def test_bitplane_kernel_rejects_bad_inputs(cuda_device):
    bp = torch.zeros((16, 128), dtype=torch.uint8, device=cuda_device)
    qi = torch.ones((4, 64), dtype=torch.int8, device=cuda_device)
    with pytest.raises(TypeError):
        tts.subblock_mins_bitplane_cuda(qi, bp.to(torch.int8), 128, 16, 16)
    with pytest.raises(ValueError):
        tts.subblock_mins_bitplane_cuda(qi, bp, 128, 24, 16)     # not 16k
    with pytest.raises(ValueError):
        tts.subblock_mins_bitplane_cuda(qi, bp, 129, 16, 16)     # > 8G rows
    with pytest.raises(ValueError):
        tts.subblock_mins_bitplane_cuda(qi.cpu(), bp, 128, 16, 16)


def _ln_inputs(rng, N, D, F_, device):
    t = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32))
    x = (t(N, D) * 2 + 0.5).to(device, torch.bfloat16)
    gamma = (1 + 0.1 * t(D)).to(device)
    beta = (0.1 * t(D)).to(device)
    w = (t(F_, D) / np.sqrt(D)).to(device, torch.bfloat16)
    bias = (0.1 * t(F_)).to(device)
    return x, gamma, beta, w, bias


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,F_", [(1, 8, 8), (37, 64, 200), (41 * 3, 64, 192),
                                    (130, 72, 136), (33, 64, 13),
                                    (1000, 768, 2304), (1728, 768, 3072),
                                    (13824, 768, 3072)])
def test_ln_matmul_kernel_matches_plain(np_rng, cuda_device, N, D, F_):
    """bf16 kernel vs the plain version, any N (tails of the row tile), a K
    (= D) that is not a multiple of the 64-wide K step (8, 72), an odd
    output width (13: the epilogue's element-wise path), and the B=256 train
    step's N = 13,824:
    |d| <= 0.02 + 0.02|ref| (both round x_hat*gamma+beta and the output to
    bf16 at the same points; f32 sums in another order and fused multiply-adds
    can move a value to the neighbouring bf16 number)."""
    x, gamma, beta, w, bias = _ln_inputs(np_rng, N, D, F_, cuda_device)
    before = tln.ln_matmul_cuda.launches
    got = tln.ln_matmul(x, gamma, beta, w, bias, impl="pallas")
    torch.cuda.synchronize()
    assert tln.ln_matmul_cuda.launches == before + 1
    want = tln.ln_matmul_reference(x, gamma, beta, w, bias)
    assert got.dtype == torch.bfloat16 and got.shape == (N, F_)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.02, atol=0.02)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,F_", [(123, 64, 96), (1728, 768, 2304)])
def test_ln_matmul_gradients_match_cpu(np_rng, cuda_device, N, D, F_):
    """The autograd rule around the kernel gives the gradients the CPU gives
    (plain forward, same recomputing backward), f32 sums in another order:
    |d| <= 1e-2 + 2^-7|ref|, one bf16 ulp of the bf16 gradients (dx, dW)."""
    args = _ln_inputs(np_rng, N, D, F_, cuda_device)
    g = torch.tensor(np_rng.standard_normal((N, F_)).astype(np.float32))
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        leaves = [a.detach().to(dev).requires_grad_(True) for a in args]
        out = tln.ln_matmul(*leaves, impl="pallas")
        out.backward(g.to(dev, out.dtype))
        grads.append([t.grad.cpu().float() for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-2)


@pytest.mark.cuda
def test_ln_matmul_kernel_rejects_bad_inputs(np_rng, cuda_device):
    x, gamma, beta, w, bias = _ln_inputs(np_rng, 8, 64, 64, cuda_device)
    with pytest.raises(TypeError):
        tln.ln_matmul_cuda(x.float(), gamma, beta, w, bias)
    with pytest.raises(ValueError):
        tln.ln_matmul_cuda(x[:, :60], gamma[:60], beta[:60], w[:, :60], bias)


def _qkv(rng, B, L, H, hd, device):
    qkv = torch.tensor(rng.standard_normal((B, L, 3 * H * hd)).astype(
        np.float32)).to(device, torch.bfloat16)
    return [t.reshape(B, L, H, hd) for t in qkv.split(H * hd, dim=-1)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,hd", [(2, 16, 4, 16), (3, 41, 4, 16),
                                      (32, 54, 12, 64), (4, 197, 12, 64),
                                      (2, 197, 12, 64), (3, 41, 4, 32),
                                      (2, 16, 4, 128)])
def test_attention_kernel_matches_plain(np_rng, cuda_device, B, L, H, hd):
    """bf16 kernel vs the plain version at every head width it takes, q|k|v
    read in place from one (B, L, 3D) tensor: |d| <= 0.01 + 0.01|ref| (the
    probabilities kept at f32 precision as P_hi + P_lo, one bf16 rounding
    at the output; f32 sums in another order)."""
    q, k, v = _qkv(np_rng, B, L, H, hd, cuda_device)
    assert not q.is_contiguous()
    before = tat.attention_cuda.launches
    got = tat.attention(q, k, v, impl="pallas")
    torch.cuda.synchronize()
    assert tat.attention_cuda.launches == before + 1
    want = tat.attention_reference(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == (B, L, H, hd)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.01, atol=0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,hd", [(2, 41, 4, 16), (32, 54, 12, 64)])
def test_attention_gradients_match_cpu(np_rng, cuda_device, B, L, H, hd):
    """The recomputing backward around the kernel gives the CPU's gradients
    (bf16 q*scale.k on both, f32 after): atol 2e-2 on bf16 gradients."""
    args = _qkv(np_rng, B, L, H, hd, cuda_device)
    g = torch.tensor(np_rng.standard_normal((B, L, H, hd)).astype(np.float32))
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        leaves = [a.detach().to(dev).requires_grad_(True) for a in args]
        out = tat.attention(*leaves, impl="pallas")
        out.backward(g.to(dev, out.dtype))
        grads.append([t.grad.cpu().float() for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_attention_kernel_rejects_bad_inputs(np_rng, cuda_device):
    q, k, v = _qkv(np_rng, 2, 16, 4, 16, cuda_device)
    with pytest.raises(TypeError):
        tat.attention_cuda(q.float(), k, v)
    with pytest.raises(ValueError):
        tat.attention_cuda(q, k[:, :8], v)
    with pytest.raises(ValueError):
        tat.attention_cuda(q.transpose(-1, -2), k.transpose(-1, -2),
                           v.transpose(-1, -2))
    with pytest.raises(ValueError, match="head widths"):
        tat.attention_cuda(*_qkv(np_rng, 2, 16, 8, 8, cuda_device))
    with pytest.raises(ValueError, match="shared memory"):
        tat.attention_cuda(*_qkv(np_rng, 1, 257, 2, 128, cuda_device))
    lib = tat._lib()
    for L, hd in ((54, 64), (197, 64), (512, 64), (256, 128), (41, 32)):
        assert lib.attention_smem_bytes(L, hd) == tat._smem_bytes(L, hd)


# ---------------------------------------------------------------------------
# the model at compute dtype float32 on the card
# ---------------------------------------------------------------------------

_F32_VISION = dict(hidden_size=128, intermediate_size=256, num_layers=2,
                   num_heads=4, image_size=64, patch_size=16, projection_dim=64)
_F32_HEAD = dict(nbit=64, nclass=10, ncontext=4, center_dim=32,
                 text_projection_dims=(32,))


def _concepthash(dtype, device, **vision):
    """The canonical model's layout at a small width, random weights from
    seed 0 (the adapters' up-projections too, so they carry signal)."""
    from concepthash_tpu_torch.models.clip import (AdapterConfig,
                                                   ClipVisionConfig)
    from concepthash_tpu_torch.models.concepthash import (ConceptHash,
                                                          ConceptHashConfig)

    g = torch.Generator().manual_seed(0)
    model = ConceptHash(ClipVisionConfig(**_F32_VISION, **vision),
                        ConceptHashConfig(**_F32_HEAD),
                        AdapterConfig(bottleneck_dim=32), dtype=dtype,
                        device=device, generator=g)
    with torch.no_grad():
        for layer in model.backbone.layers:
            for ad in (layer.adapter_attn, layer.adapter_mlp):
                ad.up.weight.copy_(0.02 * torch.randn(ad.up.weight.shape,
                                                      generator=g))
    return model.eval()


@pytest.mark.cuda
def test_concepthash_f32_encodes_on_card(cuda_device):
    """ConceptHash at compute dtype float32 (the flagship config's) encodes
    on the card through the discrete path (the layer kernel takes bf16
    only): its codes agree in sign on >= 99% of bits with the same weights'
    f32 encode on the CPU and with a bf16 encode on the card, whose layers
    run the kernel."""
    images = torch.randn(64, 64, 64, 3, generator=torch.Generator()
                         .manual_seed(1))
    launches = tfl.encoder_layer_cuda.launches
    with torch.no_grad():
        f32 = _concepthash(torch.float32, cuda_device)(
            images.to(cuda_device))["codes"]
        assert tfl.encoder_layer_cuda.launches == launches
        cpu = _concepthash(torch.float32, "cpu")(images)["codes"]
        bf16 = _concepthash(torch.bfloat16, cuda_device)(
            images.to(cuda_device))["codes"]
    assert tfl.encoder_layer_cuda.launches == launches + 2
    assert f32.shape == (64, 64) and torch.isfinite(f32).all()
    assert ((f32.cpu() > 0) == (cpu > 0)).float().mean() >= 0.99
    assert ((f32 > 0) == (bf16 > 0)).float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("vision", [dict(fused_ln="pallas"),
                                    dict(fused_ln="pallas_mlp"),
                                    dict(fused_ln="pallas_layer"),
                                    dict(attention_impl="pallas")])
def test_kernel_settings_at_f32_raise_on_card(cuda_device, vision):
    """The settings that name the kernels raise at float32 on the card when
    the model is built, and build at bf16."""
    with pytest.raises(ValueError, match="bfloat16 only"):
        _concepthash(torch.float32, cuda_device, **vision)
    assert _concepthash(torch.bfloat16, cuda_device, **vision) is not None


def _tiny_training(vision, optim=None, **over):
    """The canonical ConceptHash at a tiny size in bf16, with the optimizer
    a graphed run uses (capturable, float32 rates); ``optim`` replaces
    adam; ``over`` updates config groups (``model={...}``, ...)."""
    from concepthash_tpu_torch.methods import build_training
    from concepthash_tpu_torch.train.optim import make_capturable

    cfg = {
        "model": {"name": "concepthash", "nbit": 16, "nclass": 10,
                  "ncontext": 4, "has_adapter": True,
                  "adapter_bottleneck_dim": 16,
                  "upt_config": {"num_heads": 8, "dropout": 0.1},
                  "text_projection_dims": [32]},
        "backbone": {"name": "tiny", "hidden_size": 64,
                     "intermediate_size": 128, "num_layers": 2,
                     "num_heads": 4, "patch_size": 8, "image_size": 32,
                     "projection_dim": 32},
        "criterion": {"name": "lgh", "margin": 0.2, "scale": 8},
        "optim": optim or {"name": "adam", "lr": 0.001,
                           "weight_decay": 0.00001},
        "scheduler": {"name": "csw", "warmup_epochs": 2},
        "epochs": 10, "backbone_lr_scale": 0, "compute_dtype": "bfloat16",
        "seed": 0,
    }
    for group, keys in over.items():
        cfg[group] = {**cfg[group], **keys}
    centers = np.random.default_rng(1).standard_normal((10, 32)).astype(
        np.float32)
    tr = build_training(cfg, centers, 3, device="cuda", vision=vision)
    make_capturable(tr.optimizer)
    return tr


# configs/optim/sgd.yaml, with and without nesterov
_SGD = {"name": "sgd", "lr": 0.001, "momentum": 0.9, "weight_decay": 0.0005}


@pytest.mark.cuda
@pytest.mark.parametrize("vision, optim", [
    (None, None), (dict(attention_impl="pallas", fused_ln="pallas"), None),
    (None, _SGD), (None, dict(_SGD, nesterov=True))])
def test_graphed_train_steps_equal_eager_steps(cuda_device, vision, optim):
    """Three chunks of K=2 steps (a warm-up, then replays; dropout on)
    against six eager steps from the same state: losses, parameters, sgd's
    momentum buffers and the dropout generator bit for bit; the kernels
    counted per replay."""
    _graph_vs_eager(cuda_device, vision, optim)


_KERNELS = dict(attention_impl="pallas", fused_ln="pallas")
_FILIP = {"filip": True, "token_embeds_array": np.random.default_rng(2)
          .standard_normal((10, 5, 32)).astype(np.float32)}
_FILIP_LOSS = {"loss_scales": {"bin_logits": 1, "cont_logits": 1,
                               "concept_logits": 1, "filip_logits": 1}}


@pytest.mark.cuda
@pytest.mark.parametrize("option", ["sa_dbn", "filip", "lars", "vpt_remat",
                                    "qkvo"])
def test_graphed_option_steps_equal_eager_steps(cuda_device, option):
    """As above, with kernels 5 and 6, for the options: SelfAttentionAtLast
    (concepthash_sa.yaml's, argmax-centred Gaussian mask on the 4 x 4 grid)
    with the decorrelated BatchNorm, whose running statistics also equal;
    FILIP's token logits in the loss; lars (momentum buffers equal);
    vpt_pe with backbone.remat (each layer's forward recomputed, so the
    kernels launch twice a layer a step); q/k/v/out adapters (no LN ->
    matmul kernel)."""
    over = {
        "sa_dbn": dict(model={"self_attn_at_last": {"mask_sigma": 0.5},
                              "add_bn": "dbn"}),
        "filip": dict(model=_FILIP, criterion=_FILIP_LOSS),
        "lars": dict(optim={"name": "lars", "lr": 0.1, "momentum": 0.9,
                            "weight_decay": 1e-4}),
        "vpt_remat": dict(model={"vpt_pe": True}, backbone={"remat": True}),
        "qkvo": dict(model={"attention_adapter": True}),
    }[option]
    _graph_vs_eager(cuda_device, _KERNELS, over.pop("optim", None), **over)


def _graph_vs_eager(cuda_device, vision, optim, **over):
    from concepthash_tpu_torch.train.state import make_multi_train_step

    graph = _tiny_training(vision, optim, **over)
    eager = _tiny_training(vision, optim, **over)
    eager.model.load_state_dict(graph.model.state_dict())
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    images = torch.randn(3, 2, 4, 32, 32, 3, generator=gen,
                         device=cuda_device)
    labels = torch.nn.functional.one_hot(
        torch.randint(0, 10, (3, 2, 4), generator=gen, device=cuda_device),
        10).float()
    multi = make_multi_train_step(graph.model, graph.loss_fn,
                                  graph.optimizer, graph.scheduler,
                                  generator=graph.generator)
    got = torch.cat([multi({"image": images[c], "label": labels[c]})["loss"]
                     for c in range(3)])
    want = torch.stack([eager.step({"image": images[c, k],
                                    "label": labels[c, k]})["loss"]
                        for c in range(3) for k in range(2)])
    assert multi.replays == 2
    assert torch.equal(got, want)
    for (n, p), q in zip(graph.model.named_parameters(),
                         eager.model.parameters()):
        assert torch.equal(p, q), n
        if optim and p.requires_grad:
            assert torch.equal(graph.optimizer.state[p]["momentum_buffer"],
                               eager.optimizer.state[q]["momentum_buffer"]), n
    for (n, b), c in zip(graph.model.named_buffers(), eager.model.buffers()):
        assert torch.equal(b, c), n
    assert torch.equal(graph.generator.get_state(),
                       eager.generator.get_state())
    assert graph.scheduler.last_epoch == eager.scheduler.last_epoch == 6
    if vision:
        # 2 steps x 2 layers, each layer's forward twice under remat
        runs = 2 * 2 * (2 if over.get("backbone", {}).get("remat") else 1)
        ln = 0 if over.get("model", {}).get("attention_adapter") else 2 * runs
        want = {"attention_cuda": runs, **({"ln_matmul_cuda": ln} if ln
                                           else {})}
        assert multi.launches_per_replay == want


@pytest.mark.cuda
@pytest.mark.parametrize("fused_ln", ["auto", "pallas"])
@pytest.mark.parametrize("model", [
    {"vpt_pe": True}, {"attention_adapter": True},
    {"self_attn_at_last": {"mask_sigma": 0.5}, "add_bn": "dbn"}, _FILIP],
    ids=["vpt_pe", "qkvo", "sa_dbn", "filip"])
def test_option_encodes_take_their_kernels(cuda_device, model, fused_ln):
    """An eval encode with ``attention_impl="pallas"``: under
    ``fused_ln="auto"`` kernel 1 once a layer with vpt_pe (its prompts added
    between the layer launches), SA + DBN and FILIP; under 'pallas' the
    discrete path with kernels 5 and 6 (LN1 -> q|k|v and LN2 -> fc1 a
    layer). q/k/v/out adapters take neither kernel 1 nor kernel 6 (the
    reference turns fusion off there), kernel 5 only. Finite codes."""
    tr = _tiny_training(dict(attention_impl="pallas", fused_ln=fused_ln),
                        model=model)
    images = torch.randn(16, 32, 32, 3, generator=torch.Generator()
                         .manual_seed(6))
    counts = lambda: (tfl.encoder_layer_cuda.launches,  # noqa: E731
                      tln.ln_matmul_cuda.launches, tat.attention_cuda.launches)
    before = counts()
    with torch.no_grad():
        codes = tr.model.eval()(images.to(cuda_device))["codes"]
    got = tuple(a - b for a, b in zip(counts(), before))
    if model.get("attention_adapter"):
        assert got == (0, 0, 2)
    else:
        assert got == ((2, 0, 0) if fused_ln == "auto" else (0, 4, 2))
    assert codes.shape == (16, 16) and torch.isfinite(codes).all()


@pytest.mark.cuda
def test_graphed_eval_steps_equal_eager_steps(cuda_device):
    from concepthash_tpu_torch.train.state import (make_eval_step,
                                                   make_multi_eval_step)

    tr = _tiny_training(None)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    images = torch.randn(2, 4, 32, 32, 3, generator=gen, device=cuda_device)
    labels = torch.nn.functional.one_hot(
        torch.randint(0, 10, (2, 4), generator=gen, device=cuda_device),
        10).float()
    multi = make_multi_eval_step(tr.model, tr.loss_fn)
    batches = {"image": images, "label": labels}
    multi(batches)
    tfl.encoder_layer_cuda.launches = 0
    codes, metrics = multi(batches)
    assert tfl.encoder_layer_cuda.launches == 2 * 2
    assert multi.launches_per_replay == {"encoder_layer_cuda": 2 * 2}
    step = make_eval_step(tr.model, tr.loss_fn)
    for k in range(2):
        c, m = step({"image": images[k], "label": labels[k]})
        assert torch.equal(codes["codes"][k], c["codes"])
        assert torch.equal(metrics["loss"][k], m["loss"])


def _card_run(tmp_path, name, *extra):
    """main_gpu's argv for a 2-epoch run on the card: 3 classes x 12 train
    images at batch 4 (9 steps an epoch: a chunk of 8 and a single step at
    train_chunk auto), float32, ``save_training_state``."""
    data = tmp_path / "data" / "synthetic"
    if not data.exists():
        from concepthash_tpu_torch.data.synthetic import \
            make_synthetic_dataset

        make_synthetic_dataset(str(data), nclass=3, per_class_train=12,
                               per_class_test=2, image_size=64)
    return ["dataset=synthetic", "model=concepthash", "backbone=tiny_test",
            "model.nbit=16", "model.text_projection_dims=[32]",
            "batch_size=4", "epochs=2", "eval_interval=1",
            f"data_dir={tmp_path}", f"logdir={tmp_path / name}", "seed=5",
            "save_training_state=true", *extra]


def _main_gpu():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import main_gpu

    return main_gpu


@pytest.mark.cuda
def test_sgd_run_at_auto_chunk_on_card(cuda_device, tmp_path):
    """optim=sgd at the default train_chunk (auto: 8 on the card) trains
    through a graph replay, and exp=validation on its run builds no
    training objects and scores its last model to its last record."""
    import json

    main_gpu = _main_gpu()
    exp = main_gpu.build_experiment(_card_run(tmp_path, "sgd", "optim=sgd"))
    assert exp.train_chunk == 8
    assert type(exp.training.optimizer).__name__ == "CapturableSGD"
    exp.main()
    assert exp.train_multi_step.replays == 1
    with open(tmp_path / "sgd" / "train_history.json") as f:
        train = json.load(f)
    with open(tmp_path / "sgd" / "test_history.json") as f:
        test = json.load(f)
    assert len(train) == 2 and all(np.isfinite(r["loss"]) for r in train)
    ev = main_gpu.build_experiment(["exp=validation",
                                    f"logdir={tmp_path / 'sgd'}",
                                    f"data_dir={tmp_path}", "use_last=true"])
    assert not hasattr(ev.exp, "training")
    assert ev.main()["mAP"] == pytest.approx(test[-1]["mAP"], abs=1e-6)


@pytest.mark.cuda
def test_graphed_run_resumes_bit_for_bit(cuda_device, tmp_path):
    """A run at train_chunk auto stopped after epoch 1 and resumed (its
    chunk warmed up again, then graphed) equals the uninterrupted run (whose
    second epoch is a replay): train records and parameters bit for bit."""
    import json

    main_gpu = _main_gpu()
    whole = main_gpu.build_experiment(_card_run(tmp_path, "whole"))
    whole.main()
    first = main_gpu.build_experiment(_card_run(tmp_path, "first"))
    first.epochs = 1
    first.main()
    resumed = main_gpu.build_experiment(_card_run(
        tmp_path, "resumed", f"resume_logdir={tmp_path / 'first'}"))
    assert resumed.start_epoch == 1
    resumed.main()
    assert whole.train_multi_step.replays == 1
    histories = []
    for name in ("whole", "resumed"):
        with open(tmp_path / name / "train_history.json") as f:
            histories.append([{k: v for k, v in r.items() if k != "time"}
                              for r in json.load(f)])
    assert histories[0] == histories[1]
    sw, sr = whole.model.state_dict(), resumed.model.state_dict()
    for k in sw:
        assert torch.equal(sw[k], sr[k]), k


@pytest.mark.cuda
def test_train_chunk_1_equals_chunked_run_bit_for_bit(cuda_device, tmp_path):
    """One optimizer arithmetic for every step: the same seed at
    ``train_chunk=1`` and at ``train_chunk=8`` (9 steps an epoch: a chunk of
    8, the warm-up in epoch 1 and a replay in epoch 2, then a single tail
    step) gives the same train records and final parameters bit for bit.
    Both runs take the capturable optimizer with float32 rates."""
    import json

    main_gpu = _main_gpu()
    runs = {}
    for chunk in ("1", "8"):
        exp = main_gpu.build_experiment(_card_run(
            tmp_path, f"chunk{chunk}", f"train_chunk={chunk}"))
        assert exp.training.optimizer.param_groups[0]["capturable"]
        exp.main()
        with open(tmp_path / f"chunk{chunk}" / "train_history.json") as f:
            train = [{k: v for k, v in r.items() if k != "time"}
                     for r in json.load(f)]
        runs[chunk] = (exp, train)
    assert runs["1"][0].train_multi_step is None
    assert runs["8"][0].train_multi_step.replays == 1
    assert runs["1"][1] == runs["8"][1]
    s1, s8 = (runs[c][0].model.state_dict() for c in ("1", "8"))
    for k in s1:
        assert torch.equal(s1[k], s8[k]), k



def _tiny_baseline(name, vision=None, dtype="bfloat16"):
    """A supervised baseline on the tiny trunk (hidden 64, 2 layers, 32^2
    images), 16 bits, 10 classes, adam and csw as configs/model/*.yaml
    have them; orthohash with its seeded signed codebook, the adapters'
    up-projections seeded so they carry signal."""
    from concepthash_tpu_torch.methods import build_training

    cfg = {
        "model": {"name": name, "nbit": 16, "nclass": 10,
                  "has_adapter": True, "adapter_bottleneck_dim": 16,
                  "add_bn": True},
        "backbone": {"name": "tiny", "hidden_size": 64,
                     "intermediate_size": 128, "num_layers": 2,
                     "num_heads": 4, "patch_size": 8, "image_size": 32,
                     "projection_dim": 32},
        "criterion": {"ce": 1, "s": 8, "m": 0.2, "m_type": "cos"},
        "optim": {"name": "adam", "lr": 0.001, "weight_decay": 0.00001},
        "scheduler": {"name": "csw", "warmup_epochs": 2},
        "epochs": 10, "backbone_lr_scale": 0, "compute_dtype": dtype,
        "seed": 0,
    }
    rng = np.random.default_rng(1)
    codebook = np.where(rng.standard_normal((10, 16)) > 0, 1.0,
                        -1.0).astype(np.float32)
    tr = build_training(cfg, codebook, 3, device="cuda", vision=vision)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for layer in tr.model.backbone.tower.layers:
            for ad in (layer.adapter_attn, layer.adapter_mlp):
                ad.up.weight.copy_(0.1 * torch.randn(ad.up.weight.shape,
                                                     generator=g))
    return tr


@pytest.mark.cuda
def test_orthohash_encode_takes_kernel_1(cuda_device):
    """orthohash's bf16 eval encode runs kernel 1 once a layer, and its
    codes agree in sign on >= 99% of bits with the same weights' encode
    through the layer's plain version."""
    from concepthash_tpu_torch.models import clip

    model = _tiny_baseline("orthohash").model.eval()
    images = torch.randn(16, 32, 32, 3, generator=torch.Generator()
                         .manual_seed(6)).to(cuda_device)
    before = tfl.encoder_layer_cuda.launches
    with torch.no_grad():
        out = model(images)
        assert tfl.encoder_layer_cuda.launches == before + 2
        saved = clip.encoder_layer
        clip.encoder_layer = lambda x, w, **kw: tfl.layer_reference(x, w,
                                                                    **kw)
        try:
            plain = model(images)
        finally:
            clip.encoder_layer = saved
    assert tfl.encoder_layer_cuda.launches == before + 2
    assert out["codes"].shape == (16, 16) and torch.isfinite(
        out["logits"]).all()
    agree = ((out["codes"] > 0) == (plain["codes"] > 0)).float().mean()
    assert agree >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("vision", [None, _KERNELS], ids=["auto", "kernels"])
def test_graphed_orthohash_steps_equal_eager_steps(cuda_device, vision):
    """Three chunks of K=2 orthohash steps (a warm-up, then replays)
    against six eager steps from the same state: losses, parameters and
    the code BatchNorm's running statistics bit for bit; with kernels 5
    and 6, counted per replay."""
    from concepthash_tpu_torch.train.state import make_multi_train_step

    graph = _tiny_baseline("orthohash", vision)
    eager = _tiny_baseline("orthohash", vision)
    eager.model.load_state_dict(graph.model.state_dict())
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    images = torch.randn(3, 2, 4, 32, 32, 3, generator=gen,
                         device=cuda_device)
    labels = torch.nn.functional.one_hot(
        torch.randint(0, 10, (3, 2, 4), generator=gen, device=cuda_device),
        10).float()
    multi = make_multi_train_step(graph.model, graph.loss_fn,
                                  graph.optimizer, graph.scheduler,
                                  generator=graph.generator)
    got = torch.cat([multi({"image": images[c], "label": labels[c]})["loss"]
                     for c in range(3)])
    want = torch.stack([eager.step({"image": images[c, k],
                                    "label": labels[c, k]})["loss"]
                        for c in range(3) for k in range(2)])
    assert multi.replays == 2 and torch.equal(got, want)
    sg, se = graph.model.state_dict(), eager.model.state_dict()
    assert "hash_bn.running_var" in sg and "ce_fc.centroids" in sg
    for k in sg:
        assert torch.equal(sg[k], se[k]), k
    if vision:
        assert multi.launches_per_replay == {"attention_cuda": 4,
                                             "ln_matmul_cuda": 8}


def _tiny_finegrained(name, vision=None):
    """A fine-grained head on the tiny trunk (hidden 64, 2 layers, 32^2
    images in a 4 x 4 patch grid), 16 bits, 10 classes, 4 maps, bf16, adam
    and csw, the criterion of its configs/model/*.yaml; the adapters'
    up-projections seeded so they carry signal."""
    from concepthash_tpu_torch.methods import build_training

    crit = {"a2net_ce": {"gamma": 0, "hash": 1, "decorr": 0.01},
            "semicon_ce": {"gamma": 0.001, "loss_method": "ce"}}[name]
    cfg = {
        "model": {"name": name, "nbit": 16, "nclass": 10, "num_attns": 4,
                  "has_adapter": True, "adapter_bottleneck_dim": 16},
        "backbone": {"name": "tiny", "hidden_size": 64,
                     "intermediate_size": 128, "num_layers": 2,
                     "num_heads": 4, "patch_size": 8, "image_size": 32,
                     "projection_dim": 32},
        "criterion": crit,
        "optim": {"name": "adam", "lr": 0.001, "weight_decay": 0.00001},
        "scheduler": {"name": "csw", "warmup_epochs": 2},
        "epochs": 10, "backbone_lr_scale": 0, "compute_dtype": "bfloat16",
        "seed": 0,
    }
    tr = build_training(cfg, None, 3, device="cuda", vision=vision)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for layer in tr.model.backbone.tower.layers:
            for ad in (layer.adapter_attn, layer.adapter_mlp):
                ad.up.weight.copy_(0.1 * torch.randn(ad.up.weight.shape,
                                                     generator=g))
    return tr


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["semicon_ce", "a2net_ce"])
@pytest.mark.parametrize("vision", [None, _KERNELS], ids=["auto", "kernels"])
def test_graphed_finegrained_steps_equal_eager_steps(cuda_device, name,
                                                     vision):
    """Three chunks of K=2 steps of a fine-grained head (a warm-up, then
    replays; SEMICON-CE's batch-global suppression mask inside the graph)
    against six eager steps from the same state: losses and parameters bit
    for bit; with kernels 5 and 6, counted per replay (the heads' own
    attention takes the einsum path)."""
    from concepthash_tpu_torch.train.state import make_multi_train_step

    graph = _tiny_finegrained(name, vision)
    eager = _tiny_finegrained(name, vision)
    eager.model.load_state_dict(graph.model.state_dict())
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    images = torch.randn(3, 2, 4, 32, 32, 3, generator=gen,
                         device=cuda_device)
    labels = torch.nn.functional.one_hot(
        torch.randint(0, 10, (3, 2, 4), generator=gen, device=cuda_device),
        10).float()
    multi = make_multi_train_step(graph.model, graph.loss_fn,
                                  graph.optimizer, graph.scheduler,
                                  generator=graph.generator)
    got = torch.cat([multi({"image": images[c], "label": labels[c]})["loss"]
                     for c in range(3)])
    want = torch.stack([eager.step({"image": images[c, k],
                                    "label": labels[c, k]})["loss"]
                        for c in range(3) for k in range(2)])
    assert multi.replays == 2 and torch.equal(got, want)
    assert torch.isfinite(got).all()
    sg, se = graph.model.state_dict(), eager.model.state_dict()
    for k in sg:
        assert torch.equal(sg[k], se[k]), k
    if vision:
        assert multi.launches_per_replay == {"attention_cuda": 4,
                                             "ln_matmul_cuda": 8}


@pytest.mark.cuda
def test_cache_images_run_equals_default_run_bit_for_bit(cuda_device,
                                                         tmp_path):
    """``cache_images=true`` keeps the decoded arrays the default run
    decodes every epoch: the same train records and final parameters, bit
    for bit, at train_chunk auto."""
    import json

    main_gpu = _main_gpu()
    runs = {}
    for name, extra in (("default", ()), ("cache", ("cache_images=true",))):
        exp = main_gpu.build_experiment(_card_run(tmp_path, name, *extra))
        assert (exp.loaders["train"].source._cache is not None) == bool(extra)
        exp.main()
        with open(tmp_path / name / "train_history.json") as f:
            runs[name] = (exp, [{k: v for k, v in r.items() if k != "time"}
                                for r in json.load(f)])
    assert runs["default"][1] == runs["cache"][1]
    sd, sc = (runs[n][0].model.state_dict() for n in ("default", "cache"))
    for k in sd:
        assert torch.equal(sd[k], sc[k]), k


@pytest.mark.cuda
def test_dcc_on_card_matches_cpu(cuda_device):
    """``solve_dcc`` on the card against the CPU from seeded inputs (1,200
    train rows, a subset of 400, 64 bits): +-1 codes equal on >= 99.9% of
    entries (a sign whose argument is within rounding of 0 may flip)."""
    from concepthash_tpu_torch.losses.baselines import soften_sim, solve_dcc

    rng = np.random.default_rng(8)
    n_train, m, nbit = 1200, 400, 64
    labels = rng.integers(0, 20, n_train)
    omega = rng.choice(n_train, m, replace=False)
    S = soften_sim(torch.tensor((labels[omega][:, None] == labels[None, :])
                                .astype(np.float32) * 2 - 1))
    U = torch.tanh(torch.tensor(rng.standard_normal((m, nbit)),
                                dtype=torch.float32))
    V = torch.tensor(np.sign(rng.standard_normal((n_train, nbit))),
                     dtype=torch.float32)
    want = solve_dcc(V, U, S, omega, 200.0, nbit)
    got = solve_dcc(V.to(cuda_device), U.to(cuda_device), S.to(cuda_device),
                    omega, 200.0, nbit)
    assert got.device.type == "cuda"
    assert set(got.unique().tolist()) == {-1.0, 1.0}
    assert (got.cpu() == want).float().mean() >= 0.999
    assert (want != V).any()


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["ae", "induced_ae_norm_cossim"])
def test_ae_fit_on_card_matches_cpu(cuda_device, method):
    """``ae_fit`` on the card (three eager iterations, then one CUDA graph
    of an iteration replayed) against the CPU's loop from one init: the
    codes within 1e-3 and their signs equal on >= 99%."""
    from concepthash_tpu_torch.train.codebook import ae_fit, ae_init

    emb = np.random.default_rng(9).standard_normal((20, 48)).astype(
        np.float32)
    init = ae_init(48, 16, method, n_induced=64)
    kw = dict(iters=300, init=init, n_induced=64)
    card = ae_fit(emb, 16, method, device=cuda_device, **kw)
    cpu = ae_fit(emb, 16, method, device="cpu", **kw)
    assert np.isfinite(card).all()
    np.testing.assert_allclose(card, cpu, atol=1e-3)
    assert (np.sign(card) == np.sign(cpu)).mean() >= 0.99


def _tiny_unsupervised(name, vision=None):
    """An unsupervised method on the tiny trunk (hidden 64, 2 layers, 32^2
    images), 16 bits, adam and csw as configs/model/*.yaml have them, the
    adapters' up-projections seeded so they carry signal."""
    from concepthash_tpu_torch.methods import build_training

    crit = {"cibhash": {"temperature": 0.3, "beta": 0.001},
            "ssdh": {"alpha": 2.0}}[name]
    cfg = {
        "model": {"name": name, "nbit": 16, "nclass": 10,
                  "has_adapter": True, "adapter_bottleneck_dim": 16},
        "backbone": {"name": "tiny", "hidden_size": 64,
                     "intermediate_size": 128, "num_layers": 2,
                     "num_heads": 4, "patch_size": 8, "image_size": 32,
                     "projection_dim": 32},
        "criterion": crit,
        "optim": {"name": "adam", "lr": 0.001, "weight_decay": 0.00001},
        "scheduler": {"name": "csw", "warmup_epochs": 2},
        "epochs": 10, "backbone_lr_scale": 0, "compute_dtype": "bfloat16",
        "seed": 0,
    }
    tr = build_training(cfg, None, 3, device="cuda", vision=vision)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for layer in tr.model.backbone.tower.layers:
            for ad in (layer.adapter_attn, layer.adapter_mlp):
                ad.up.weight.copy_(0.1 * torch.randn(ad.up.weight.shape,
                                                     generator=g))
    return tr


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cibhash", "ssdh"])
@pytest.mark.parametrize("vision", [None, _KERNELS], ids=["auto", "kernels"])
def test_graphed_unsupervised_steps_equal_eager_steps(cuda_device, name,
                                                      vision):
    """Three chunks of K=2 steps (a warm-up, then replays) against six
    eager steps from the same state, losses and parameters bit for bit:
    CIBHash on two-view batches (2B = 8 image rows, 4 labels), SSDH with
    each step's (B, B) structure block staged as a (K, B, B) ``aux``
    buffer that every replay reads."""
    from concepthash_tpu_torch.train.state import make_multi_train_step

    graph = _tiny_unsupervised(name, vision)
    eager = _tiny_unsupervised(name, vision)
    eager.model.load_state_dict(graph.model.state_dict())
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    rows = 8 if name == "cibhash" else 4
    chunks = {"image": torch.randn(3, 2, rows, 32, 32, 3, generator=gen,
                                   device=cuda_device),
              "label": torch.nn.functional.one_hot(torch.randint(
                  0, 10, (3, 2, 4), generator=gen, device=cuda_device),
                  10).float()}
    if name == "ssdh":
        chunks["aux"] = torch.randint(-1, 2, (3, 2, 4, 4), generator=gen,
                                      device=cuda_device).to(torch.int8)
    multi = make_multi_train_step(graph.model, graph.loss_fn,
                                  graph.optimizer, graph.scheduler,
                                  generator=graph.generator)
    got = torch.cat([multi({k: v[c] for k, v in chunks.items()})["loss"]
                     for c in range(3)])
    want = torch.stack([eager.step({k: v[c, j] for k, v in chunks.items()})
                        ["loss"] for c in range(3) for j in range(2)])
    assert multi.replays == 2 and torch.equal(got, want)
    assert len(set(got.tolist())) == 6      # every step saw its own batch
    sg, se = graph.model.state_dict(), eager.model.state_dict()
    for k in sg:
        assert torch.equal(sg[k], se[k]), k
    if vision:
        assert multi.launches_per_replay == {"attention_cuda": 4,
                                             "ln_matmul_cuda": 8}


@pytest.mark.cuda
def test_bihalf_binarize_on_card_equals_cpu(cuda_device):
    """Bi-half's per-bit median threshold (the mean of the middle two at an
    even batch) and its proxy gradient on the card equal the CPU's."""
    from concepthash_tpu_torch.losses.unsupervised import bihalf_binarize

    h = torch.randn(64, 64, generator=torch.Generator().manual_seed(4))
    cpu = bihalf_binarize(h, 6.0)
    hc = h.to(cuda_device).requires_grad_()
    card = bihalf_binarize(hc, 6.0)
    card.sum().backward()
    assert torch.equal(card.detach().cpu(), cpu)
    assert ((card > 0).sum(0) == 32).all()
    assert torch.equal(hc.grad, torch.full_like(hc, 6.0))

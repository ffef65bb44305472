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

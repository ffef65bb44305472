"""Exact top-k serving over an int8 sign gallery and over a bit-plane
gallery: the subblock-min CUDA kernels of ``csrc/topk_select.cu`` and
``csrc/bitplane_mins.cu``, their plain PyTorch versions, and the selection,
rescore and certificate around them.

Counterpart of concepthash_tpu/ops/topk_select.py (the Pallas
``_mins_kernel_packed``, ``_mins_kernel`` and ``_mins_kernel_bitplane``,
``exact_topk_minspass`` and ``exact_topk_bitplane``). Differences by design:

- the mins come out query-major, (Q, m_pad) with m_pad = ceil(N / subblock)
  rounded up to a multiple of the superblock's 64 subblocks, with their
  superblock mins beside them, the layout the selection reads; the
  reference's (m, Q) is a transposed view of it (``subblock_min_dists``,
  ``subblock_min_dists_packed``, ``subblock_min_dists_bitplane``), with
  ``m = ceil(N / subblock)`` rows where the reference pads to its TPU
  row-block (those pad rows read nbit + 1 exactly as the tail rows here do);
- the bit-plane rescore gathers each selected subblock's own byte rows; the
  reference clamps the last one's start to G - gps, which misreads a ragged
  last subblock (ROADMAP Queue 3);
- the bit-plane rescore runs on int32 words of four lanes rather than eight
  {0, 1} planes and a slot-sum product;
- every ``lax.top_k`` of the reference is a stable ascending sort here, so
  ties resolve to the lower position first on every device, as ``lax.top_k``
  resolves them (``torch.topk`` makes no such promise on CUDA);
- bit-packed words are int32 tensors holding the uint32 pattern
  (``ops.hamming``);
- the reference's ``lax.cond`` on the certificate is a host-side branch.
"""

from __future__ import annotations

import ctypes

import torch

from concepthash_tpu_torch import _build
from concepthash_tpu_torch.ops.hamming import pack_bits, popcount32

# direct selection over the subblock mins below this many mins per row; above
# it the superblock hierarchy (tests monkeypatch this to force that branch)
_INNER_DIRECT_MAX = 32768

# codes bit-packed per step of pack_bits_serving (bounds its temporaries)
_PACK_CHUNK_CODES = 1 << 20

_KERNEL_NBITS = (16, 32, 64, 128)

# subblocks per superblock of the selection: the mins kernels pad their
# columns to a multiple of it and reduce each run of it
_SUB2 = 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def strict_signs(x: torch.Tensor) -> torch.Tensor:
    """Strict +-1 int8 signs: > 0 -> +1, everything else (0 included) -> -1,
    the pack_bits convention."""
    return ((x > 0).to(torch.int8) * 2 - 1).to(torch.int8)


def smallest(x: torch.Tensor, k: int):
    """(values, int64 indices) of the k smallest entries of each row in
    ascending order, lower position first among ties — ``lax.top_k(-x, k)``
    of the reference, negated back."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def pack_serving_gallery(db_signs: torch.Tensor):
    """(N, nbit) +-1 -> ((N_pad // P, 128) int8, N_pad), P = 128 // nbit
    codes per 128-byte row. Pad rows are all-zero codes (distance nbit/2),
    so callers pass ``n_valid``. The layout is a row-major reshape of the
    plain (N_pad, nbit) gallery, byte for byte the reference's."""
    db = strict_signs(db_signs)
    N, nbit = db.shape
    if 128 % nbit:
        raise ValueError(f"nbit must divide 128 for the packed layout, got {nbit}")
    P = 128 // nbit
    pad = (-N) % P
    if pad:
        db = torch.cat([db, db.new_zeros((pad, nbit))])
    return db.reshape((N + pad) // P, 128), N + pad


def _mins_reference(qi: torch.Tensor, db_i8: torch.Tensor, subblock: int,
                    m: int, out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the mins kernel: qi (Q, nbit) and db_i8 (N, nbit)
    int8 -> (m, Q) mins; entries past N count as similarity -(nbit + 2)."""
    Q, nbit = qi.shape
    N = db_i8.shape[0]
    sim = (db_i8.float() @ qi.float().t()).to(torch.int32)          # (N, Q)
    pad = m * subblock - N
    if pad:
        sim = torch.cat([sim, sim.new_full((pad, Q), -(nbit + 2))])
    gmax = sim.reshape(m, subblock, Q).amax(dim=1)
    return (0.5 * (nbit - gmax).float()).to(out_dtype)


def _mins_reference_serving(qi: torch.Tensor, db_i8: torch.Tensor,
                            subblock: int, m: int, out_dtype=torch.float32,
                            superblocks: bool = False):
    """Plain version of the mins kernels in their serving layout: qi (Q,
    nbit) and db_i8 (N, nbit) int8 -> (mins (Q, m_pad), superblock mins
    (Q, m_pad / 64) or None), m_pad = m rounded up to a multiple of 64;
    codes past N, and the pad columns, read nbit + 1."""
    Q = qi.shape[0]
    m_pad = _cdiv(m, _SUB2) * _SUB2
    mins = _mins_reference(qi, db_i8, subblock, m_pad,
                           out_dtype).t().contiguous()
    msb = mins.reshape(Q, -1, _SUB2).amin(dim=-1) if superblocks else None
    return mins, msb


def _lib():
    lib = _build.load("topk_select")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.subblock_mins_fwd.argtypes = [vp, vp, cll, ci, ci, ci, cll, ci,
                                          vp, vp, vp]
        lib.subblock_mins_fwd.restype = ci
        lib.subblock_mins_error_string.argtypes = [ci]
        lib.subblock_mins_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def subblock_mins_cuda(qi: torch.Tensor, db: torch.Tensor, n_codes: int,
                       subblock: int, m: int, out_dtype=torch.float32,
                       superblocks: bool = False):
    """Launch the mins kernel. qi: (Q, nbit) strict +-1 int8; db: int8
    gallery holding ``n_codes`` codes of nbit bytes, row-major (plain or
    128-lane packed). Returns (mins (Q, m_pad), superblock mins (Q, m_pad /
    64) or None) in ``out_dtype`` (bf16 or f32), m_pad = m rounded up to a
    multiple of 64, the pad columns at nbit + 1; the superblock mins are
    written when ``superblocks`` asks for them. ``subblock`` must be a
    multiple of 8. ``subblock_mins_cuda.launches`` counts the launches,
    ``.plain_launches`` those over a gallery in the plain (N, nbit) layout
    (the route of the reference's ``_mins_kernel``; the others came in the
    128-lane packed layout of ``_mins_kernel_packed``)."""
    Q, nbit = qi.shape
    if qi.device.type != "cuda" or db.device != qi.device:
        raise ValueError(f"subblock_mins_cuda needs q and gallery on one CUDA "
                         f"device, got {qi.device} and {db.device}")
    if qi.dtype != torch.int8 or db.dtype != torch.int8:
        raise TypeError("q and gallery must be int8")
    if nbit not in _KERNEL_NBITS:
        raise ValueError(f"the mins kernel takes nbit in {_KERNEL_NBITS}, got {nbit}")
    if subblock <= 0 or subblock % 8:
        raise ValueError(f"the mins kernel takes subblocks that are multiples "
                         f"of 8, got {subblock}")
    if db.numel() != n_codes * nbit or not 0 < n_codes < 2 ** 31:
        raise ValueError(f"gallery holds {db.numel()} bytes, expected "
                         f"{n_codes} codes x {nbit} (0 < codes < 2^31)")
    for name, t in (("q", qi), ("gallery", db)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if m < _cdiv(n_codes, subblock):
        raise ValueError(f"m={m} rows cannot hold {n_codes} codes in "
                         f"subblocks of {subblock}")
    m_pad = _cdiv(m, _SUB2) * _SUB2
    out = torch.empty((Q, m_pad), dtype=out_dtype, device=qi.device)
    msb = (torch.empty((Q, m_pad // _SUB2), dtype=out_dtype, device=qi.device)
           if superblocks else None)
    lib = _lib()
    code = lib.subblock_mins_fwd(
        _build.ptr(qi), _build.ptr(db), n_codes, Q, nbit, subblock, m,
        int(out_dtype == torch.bfloat16), _build.ptr(out),
        _build.ptr(msb) if superblocks else None,
        _build.stream_ptr(qi.device))
    _build.check(code, lib.subblock_mins_error_string, "subblock_mins_fwd")
    subblock_mins_cuda.launches += 1
    if db.shape[-1] == nbit:
        subblock_mins_cuda.plain_launches += 1
    return out, msb


subblock_mins_cuda.launches = 0
subblock_mins_cuda.plain_launches = 0


def _mins(qi, db, n_codes: int, nbit: int, subblock: int, out_dtype,
          superblocks: bool = False):
    """(mins (Q, m_pad), superblock mins or None) of ``n_codes`` codes in db
    (either layout): the kernel on CUDA, its plain version on the CPU."""
    m = _cdiv(n_codes, subblock)
    if db.device.type == "cpu":
        return _mins_reference_serving(qi, db.reshape(n_codes, nbit),
                                       subblock, m, out_dtype, superblocks)
    return subblock_mins_cuda(qi, db, n_codes, subblock, m, out_dtype,
                              superblocks)


def subblock_min_dists_packed(q_signs: torch.Tensor, db_packed: torch.Tensor,
                              subblock: int = 64,
                              out_dtype=torch.float32) -> torch.Tensor:
    """Per-subblock min Hamming distances over the packed gallery:
    (Q, nbit) x (Np, 128) int8 (P = 128 // nbit codes per row, from
    ``pack_serving_gallery``) -> (ceil(Np * P / S), Q), the reference's
    layout, as a transposed view of the kernel's (Q, m_pad). bf16 is exact
    for nbit <= 128."""
    Q, nbit = q_signs.shape
    if 128 % nbit:
        raise ValueError(f"nbit must divide 128, got {nbit}")
    P = 128 // nbit
    if subblock % P:
        raise ValueError(f"subblock {subblock} must be a multiple of P={P}")
    n_codes = db_packed.shape[0] * P
    mins, _ = _mins(strict_signs(q_signs), db_packed, n_codes, nbit,
                    subblock, out_dtype)
    return mins[:, :_cdiv(n_codes, subblock)].t()


def subblock_min_dists(q_signs: torch.Tensor, db_i8: torch.Tensor,
                       subblock: int = 64,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Per-subblock min Hamming distances, (Q, nbit) x (N, nbit) int8 +-1
    -> (ceil(N / S), Q), transposed (subblock-major): the reference's
    layout, as a transposed view of the kernel's (Q, m_pad). Entries past N
    count as distance nbit + 1."""
    Q, nbit = q_signs.shape
    N = db_i8.shape[0]
    mins, _ = _mins(strict_signs(q_signs), db_i8, N, nbit, subblock,
                    out_dtype)
    return mins[:, :_cdiv(N, subblock)].t()


def _approx_smallest_rows(x: torch.Tensor, kk: int, sub2: int = 64,
                          cap2: int | None = None, return_theta: bool = False,
                          mins2: torch.Tensor | None = None):
    """Indices of about the kk smallest entries of each row of (Q, m), by a
    superblock-min hierarchy with no exactness fallback (callers pair it
    with the certificate of ``exact_topk_minspass``).

    ``return_theta`` also returns theta, the exact min over the unselected
    entries of each row: the smaller of the (kk+1)-th gathered value and the
    (cap2+1)-th superblock min. ``mins2``: precomputed (Q, m / sub2)
    superblock mins (m must then be a multiple of sub2)."""
    Q, m = x.shape
    if cap2 is None:
        cap2 = kk
    cap2 = max(cap2, 2 * _cdiv(kk, sub2))
    if mins2 is None:
        pad = (-m) % sub2
        if pad:
            x = torch.cat([x, x.new_full((Q, pad), float("inf"))], dim=1)
        m2 = (m + pad) // sub2
        x3 = x.reshape(Q, m2, sub2)
        mins2 = x3.amin(dim=-1)
    else:
        if m % sub2:
            raise ValueError("precomputed mins2 needs a sub2-aligned m")
        m2 = m // sub2
        if tuple(mins2.shape) != (Q, m2):
            raise ValueError(f"mins2 has shape {tuple(mins2.shape)}, "
                             f"expected {(Q, m2)}")
        x3 = x.reshape(Q, m2, sub2)
    cap2 = min(cap2, m2)
    cap2p = min(cap2 + 1, m2) if return_theta else cap2
    sb_vals, si_all = smallest(mins2, cap2p)
    si = si_all[:, :cap2]
    g = torch.gather(x3, 1, si[:, :, None].expand(Q, cap2, sub2))
    g_vals, li_all = smallest(g.reshape(Q, cap2 * sub2),
                              kk + 1 if return_theta else kk)
    li = li_all[:, :kk]
    idx = torch.gather(si, 1, li // sub2) * sub2 + li % sub2
    if not return_theta:
        return idx
    theta_gathered = g_vals[:, kk]
    theta_sb = (sb_vals[:, cap2] if cap2p > cap2
                else x.new_full((Q,), float("inf")))
    return idx, torch.minimum(theta_gathered, theta_sb)


def pack_bits_serving(db_i8: torch.Tensor, nbit: int | None = None,
                      subblock: int = 64) -> torch.Tensor:
    """Bit-pack of a sign gallery for the rescore gather: (N, nbit) int8
    signs or the 128-lane packed form -> (ceil(N / subblock),
    subblock * nbit // 32) words, one subblock of codes per row. Bit j set
    iff sign > 0 (``ops.hamming.pack_bits``). Pad rows (all-zero codes)
    pack to 0 and rescore as popcount(q), not nbit/2, so galleries with pad
    rows must pass ``n_valid`` to the serving calls."""
    if nbit is None:
        if db_i8.shape[1] == 128:
            raise ValueError(
                "a 128-lane gallery is ambiguous (plain nbit=128 vs the "
                "packed layout of any nbit dividing 128) — pass nbit "
                "explicitly")
        nbit = db_i8.shape[1]
    if nbit % 32:
        raise ValueError(f"serving bit-pack needs nbit to be a multiple of "
                         f"32, got {nbit}; the sign-row rescore handles other "
                         f"widths")
    L = nbit // 32
    P = db_i8.shape[1] // nbit
    rows_per_chunk = max(1, _PACK_CHUNK_CODES // P)
    words = torch.cat([
        pack_bits(db_i8[r:r + rows_per_chunk].reshape(-1, nbit))
        for r in range(0, db_i8.shape[0], rows_per_chunk)])
    pad = (-words.shape[0]) % subblock
    if pad:
        words = torch.cat([words, words.new_zeros((pad, L))])
    return words.reshape(-1, subblock * L)


def exact_topk_minspass(q_signs: torch.Tensor, db_i8: torch.Tensor, k: int,
                        subblock: int = 64, cap: int | None = None,
                        n_valid: int | None = None,
                        db_bits: torch.Tensor | None = None,
                        retry_mult: int = 2):
    """Exact top-k candidates over an int8 sign gallery: subblock mins (the
    kernel on CUDA), selection of the ``cap`` best subblocks, and a rescore
    of their codes.

    ``db_i8`` is (N, nbit) int8 signs or the packed (Np, 128) form of
    ``pack_serving_gallery`` (detected by shape). ``db_bits``: the
    ``pack_bits_serving`` form of the same gallery; with it the rescore
    gathers words and scores by XOR and popcount; it is built here when
    omitted in the large-m regime. ``n_valid``: the real row count when the
    gallery carries pad rows; rows at or past it are masked to +inf.

    Returns (distances (Q, k) f32, indices (Q, k) int64, valid bool).
    ``valid`` is the exactness certificate: every query's k-th distance is
    strictly below the best unselected subblock min. When it fails at
    ``cap``, one retry runs at ``retry_mult * cap`` on the same mins; when
    it still fails, the caller must fall back to an exact path."""
    Q, nbit = q_signs.shape
    packed = db_i8.dim() == 2 and db_i8.shape[1] == 128 and nbit != 128
    P = 128 // nbit if packed else 1
    N = db_i8.shape[0] * P
    if cap is None:
        cap = 512
    qi = strict_signs(q_signs)
    m_real = _cdiv(N, subblock)
    nv = N if n_valid is None else int(n_valid)
    dev = qi.device

    if m_real <= cap:
        # fewer subblocks than the candidate budget: a dense rescore of the
        # whole gallery, exact unconditionally
        sim = qi.float() @ db_i8.reshape(N, nbit).float().t()
        dist = 0.5 * (nbit - sim)
        if n_valid is not None:
            col = torch.arange(N, device=dev)
            dist = torch.where(col < nv, dist, float("inf"))
        d, idx = smallest(dist, k)
        return d, idx, True

    if packed and subblock % P:
        raise ValueError(f"subblock {subblock} must be a multiple of P={P}")
    large_m = m_real > _INNER_DIRECT_MAX
    if large_m and db_bits is None and nbit % 32 == 0:
        db_bits = pack_bits_serving(db_i8, nbit, subblock=subblock)
    # bf16 mins are exact for nbit <= 128 (integers up to 129)
    mdt = torch.bfloat16 if nbit <= 128 else torch.float32
    # (Q, m_pad) with the pad columns at nbit + 1, and the superblock mins,
    # as the selection reads them
    mins, msb = _mins(qi, db_i8, N, nbit, subblock, mdt, superblocks=large_m)
    sub2 = _SUB2
    if not large_m:
        mins = mins[:, :m_real]

    if db_bits is not None:
        L = nbit // 32
        if db_bits.shape[1] % L:
            raise ValueError(f"db_bits width {db_bits.shape[1]} does not fit "
                             f"nbit={nbit}")
        if db_bits.shape[1] == subblock * L:
            src_sb = db_bits
        else:
            words = db_bits if db_bits.shape[1] == L else db_bits.reshape(-1, L)
            pad_rows = (-words.shape[0]) % subblock
            if pad_rows:
                words = torch.cat([words, words.new_zeros((pad_rows, L))])
            src_sb = words.reshape(-1, subblock * L)
        q_bits = pack_bits(qi)                                      # (Q, L)
    else:
        pad_rows = (-db_i8.shape[0]) % ((subblock // P) if packed else subblock)
        dbp = (torch.cat([db_i8, db_i8.new_zeros((pad_rows, db_i8.shape[1]))])
               if pad_rows else db_i8)
        src_sb = dbp.reshape(-1, subblock * nbit)

    def select_rescore(cap_i: int):
        if not large_m:
            mv, sel_all = smallest(mins, cap_i + 1)
            sel = sel_all[:, :cap_i]
            theta_next = mv[:, cap_i]
        else:
            sel, theta_next = _approx_smallest_rows(
                mins, cap_i, sub2=sub2, return_theta=True, mins2=msb)
        rows = (sel[:, :, None] * subblock
                + torch.arange(subblock, device=dev)).reshape(Q, cap_i * subblock)
        gathered = src_sb.index_select(
            0, sel.clamp(max=src_sb.shape[0] - 1).reshape(-1))
        if db_bits is not None:
            x = torch.bitwise_xor(gathered.reshape(Q, cap_i, subblock, L),
                                  q_bits[:, None, None, :])
            dist_c = popcount32(x).sum(dim=-1).float().reshape(
                Q, cap_i * subblock)
        else:
            cand = gathered.reshape(Q, cap_i * subblock, nbit).float()
            sim_c = torch.bmm(cand, qi.float()[:, :, None])[..., 0]
            dist_c = 0.5 * (nbit - sim_c)
        dist_c = torch.where(rows >= nv, float("inf"), dist_c)
        d, li = smallest(dist_c, k)
        idx = torch.gather(rows, 1, li)
        valid = bool((d[:, -1] < theta_next).all())
        return d, idx, valid

    d1, i1, v1 = select_rescore(cap)
    # m_real - 1: the direct branch selects cap_i + 1 mins per row
    cap_retry = min(retry_mult * cap, m_real - 1)
    if v1 or cap_retry <= cap:
        return d1, i1, v1
    return select_rescore(cap_retry)


# ---------------------------------------------------------------------------
# bit-plane serving layout: one bit per code bit (8 bytes per code at nbit=64)
# ---------------------------------------------------------------------------

_UNPACK_FORMS = ("i8_stack", "i32_shift", "i8_mask")


def pack_bitplane_serving(db: torch.Tensor, nbit: int | None = None):
    """Sign gallery -> bit-plane serving form: ((G, 128) uint8, n_pad).

    Accepts (N, nbit) +-1 signs or the 128-lane packed int8 form of
    ``pack_serving_gallery``. Bit j of ``bp[g, l]`` is the sign bit (> 0) of
    packed row 8g + j at lane l; code (8g + j) * P + p sits at lanes
    [p * nbit, (p + 1) * nbit). ``n_pad`` counts the stored codes: N rounded
    up to P codes per packed row, then to 8 packed rows per byte row. A
    bit-plane has no zero state, so both pad kinds store as all-negative
    codes (bits 0x00): serving calls pass ``n_valid``. Byte for byte the
    reference's layout."""
    if db.shape[1] == 128 and (nbit is None or nbit != 128):
        if nbit is None:
            raise ValueError(
                "a 128-lane input is ambiguous (plain nbit=128 vs the "
                "packed layout of any nbit dividing 128) — pass nbit")
        packed, n_pad = db.to(torch.int8), db.shape[0] * (128 // nbit)
    else:
        if nbit is None:
            nbit = db.shape[1]
        if db.shape[1] != nbit:
            raise ValueError(f"gallery width {db.shape[1]} is not nbit={nbit}")
        packed, n_pad = pack_serving_gallery(db)
    P = 128 // nbit
    pad_r = (-packed.shape[0]) % 8
    bits = (packed > 0).to(torch.int32)
    if pad_r:
        bits = torch.cat([bits, bits.new_zeros((pad_r, 128))])
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    bp = (bits.reshape(-1, 8, 128) << shifts[None, :, None]).sum(dim=1)
    return bp.to(torch.uint8), n_pad + pad_r * P


def unpack_bitplane(bp: torch.Tensor) -> torch.Tensor:
    """(G, 128) uint8 bit-planes -> (G * 8, 128) int8 +-1 packed rows (the
    ``pack_serving_gallery`` layout)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bp.device)
    u = ((bp[:, None, :] >> shifts[None, :, None]) & 1).to(torch.int8)
    return (u * 2 - 1).reshape(-1, 128)


def _bitplane_mins_reference(qi: torch.Tensor, bp: torch.Tensor, n_rows: int,
                             subblock: int, m: int, out_dtype=torch.float32,
                             superblocks: bool = False):
    """Plain version of the bit-plane mins kernel, in its layout: unpack the
    planes, keep the first ``n_rows`` packed rows, and take the int8
    layout's mins; codes past them, and the pad columns, read nbit + 1.
    Returns (mins (Q, m_pad), superblock mins (Q, m_pad / 64) or None),
    m_pad = m rounded up to a multiple of 64."""
    nbit = qi.shape[1]
    rows_db = unpack_bitplane(bp).reshape(-1, nbit)[:n_rows * (128 // nbit)]
    return _mins_reference_serving(qi, rows_db, subblock, m, out_dtype,
                                   superblocks)


def _bitplane_lib():
    lib = _build.load("bitplane_mins")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bitplane_mins_fwd.argtypes = [vp, vp, cll, cll, ci, ci, ci, cll,
                                          ci, vp, vp, vp]
        lib.bitplane_mins_fwd.restype = ci
        lib.bitplane_mins_error_string.argtypes = [ci]
        lib.bitplane_mins_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def subblock_mins_bitplane_cuda(qi: torch.Tensor, bp: torch.Tensor,
                                n_rows: int, subblock: int, m: int,
                                out_dtype=torch.float32,
                                superblocks: bool = False):
    """Launch the bit-plane mins kernel. qi: (Q, nbit) strict +-1 int8; bp:
    (G, 128) uint8 bit-planes, of which the first ``n_rows`` packed rows
    count. Returns (mins (Q, m_pad), superblock mins (Q, m_pad / 64) or
    None) in ``out_dtype`` (bf16 or f32), m_pad = m rounded up to a
    multiple of 64, the pad columns at nbit + 1; the superblock mins are
    written when ``superblocks`` asks for them.
    ``subblock_mins_bitplane_cuda.launches`` counts the launches."""
    Q, nbit = qi.shape
    if qi.device.type != "cuda" or bp.device != qi.device:
        raise ValueError(f"subblock_mins_bitplane_cuda needs q and gallery on "
                         f"one CUDA device, got {qi.device} and {bp.device}")
    if qi.dtype != torch.int8 or bp.dtype != torch.uint8:
        raise TypeError("q must be int8 and the bit-plane gallery uint8")
    if nbit not in _KERNEL_NBITS:
        raise ValueError(f"the mins kernel takes nbit in {_KERNEL_NBITS}, got {nbit}")
    P = 128 // nbit
    if subblock <= 0 or subblock % (8 * P):
        raise ValueError(f"subblock {subblock} must be a multiple of 8*P={8 * P}")
    if bp.dim() != 2 or bp.shape[1] != 128:
        raise ValueError(f"bit-plane gallery must be (G, 128), got {tuple(bp.shape)}")
    G = bp.shape[0]
    if not 0 <= n_rows <= G * 8:
        raise ValueError(f"n_rows={n_rows} outside [0, {G * 8}]")
    for name, t in (("q", qi), ("gallery", bp)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if m < _cdiv(G * 8 * P, subblock):
        raise ValueError(f"m={m} rows cannot hold {G * 8 * P} codes in "
                         f"subblocks of {subblock}")
    m_pad = _cdiv(m, _SUB2) * _SUB2
    out = torch.empty((Q, m_pad), dtype=out_dtype, device=qi.device)
    msb = (torch.empty((Q, m_pad // _SUB2), dtype=out_dtype, device=qi.device)
           if superblocks else None)
    lib = _bitplane_lib()
    code = lib.bitplane_mins_fwd(
        _build.ptr(qi), _build.ptr(bp), G, n_rows, Q, nbit, subblock, m,
        int(out_dtype == torch.bfloat16), _build.ptr(out),
        _build.ptr(msb) if superblocks else None,
        _build.stream_ptr(qi.device))
    _build.check(code, lib.bitplane_mins_error_string, "bitplane_mins_fwd")
    subblock_mins_bitplane_cuda.launches += 1
    return out, msb


subblock_mins_bitplane_cuda.launches = 0


def _bitplane_slots(nbit: int, subblock: int, unpack: str) -> int:
    """Checks the bit-plane geometry and the reference's ``unpack`` name (one
    of its TPU plane-extraction forms, whose mins are identical; it has no
    effect here). Returns P, the codes per packed row."""
    if unpack not in _UNPACK_FORMS:
        raise ValueError(f"unpack must be one of {_UNPACK_FORMS}, got {unpack!r}")
    if 128 % nbit:
        raise ValueError(f"nbit must divide 128, got {nbit}")
    P = 128 // nbit
    if subblock % (8 * P):
        raise ValueError(f"subblock {subblock} must be a multiple of 8*P={8 * P}")
    return P


def _mins_bitplane(qi, bp, n_rows: int, subblock: int, m: int, out_dtype,
                   superblocks: bool = False):
    if bp.device.type == "cpu":
        return _bitplane_mins_reference(qi, bp, n_rows, subblock, m, out_dtype,
                                        superblocks)
    return subblock_mins_bitplane_cuda(qi, bp, n_rows, subblock, m, out_dtype,
                                       superblocks)


def subblock_min_dists_bitplane(q_signs: torch.Tensor, bp: torch.Tensor,
                                subblock: int = 256,
                                out_dtype=torch.float32,
                                n_rows: int | None = None,
                                unpack: str = "i8_stack") -> torch.Tensor:
    """Per-subblock min Hamming distances over a bit-plane gallery:
    (Q, nbit) x (G, 128) uint8 (``pack_bitplane_serving``) ->
    (ceil(G * 8 * P / S), Q), bf16 exact for nbit <= 128: the reference's
    layout, as a transposed view of the kernel's (Q, m_pad). Needs
    ``subblock % (8 * P) == 0``, so a byte row never straddles two
    subblocks. ``n_rows``: the valid packed rows (default: all stored);
    codes of later rows read nbit + 1. ``unpack``: see ``_bitplane_slots``."""
    P = _bitplane_slots(q_signs.shape[1], subblock, unpack)
    G = bp.shape[0]
    if n_rows is None:
        n_rows = G * 8
    m = _cdiv(G * 8 * P, subblock)
    mins, _ = _mins_bitplane(strict_signs(q_signs), bp, int(n_rows), subblock,
                             m, out_dtype)
    return mins[:, :m].t()


def _bitplane_rescore(gath: torch.Tensor, qb: torch.Tensor,
                      nbit: int) -> torch.Tensor:
    """Hamming distances of every code in gathered byte rows:
    gath (Q, C, 128) uint8, qb (Q, 128) uint8 (0xFF where the query's bit
    for that lane is set) -> (Q, C, 8, P) int32, in (byte row, plane, slot)
    order. Runs on int32 words of four lanes each: a word's plane-j bits are
    ``(w >> j) & 0x01010101``, summed over the slot's nbit/4 words with one
    byte per lane (each at most nbit/4 < 256), then the four bytes added."""
    Q, C, _ = gath.shape
    P = 128 // nbit
    x = torch.bitwise_xor(gath, qb[:, None, :]).view(torch.int32)
    x = x.reshape(Q, C, P, nbit // 4)                       # (Q, C, P, words)
    planes = []
    for j in range(8):
        s = ((x >> j) & 0x01010101).sum(dim=-1, dtype=torch.int32)
        planes.append((s & 0xFF) + ((s >> 8) & 0xFF) + ((s >> 16) & 0xFF)
                      + ((s >> 24) & 0xFF))                  # (Q, C, P)
    return torch.stack(planes, dim=2)


def exact_topk_bitplane(q_signs: torch.Tensor, bp: torch.Tensor, k: int,
                        subblock: int = 128, cap: int | None = None,
                        n_valid: int | None = None, retry_mult: int = 2,
                        unpack: str = "i8_stack"):
    """Exact top-k over a bit-plane gallery (``pack_bitplane_serving``): the
    bit-plane mins (the kernel on CUDA), the selection of the ``cap`` best
    subblocks, and a rescore of their codes gathered as whole byte rows of
    the same stored array, with the certificate and one retry of
    ``exact_topk_minspass``.

    Galleries that store more codes than they hold (both pad kinds) pass
    ``n_valid`` = the real N; codes at or past it are masked to +inf. A
    Python int ``n_valid`` also masks the pad rows in the mins.

    Returns (distances (Q, k) f32, indices (Q, k) int64, valid bool);
    ``valid`` False means the caller must use an exact fallback."""
    Q, nbit = q_signs.shape
    P = _bitplane_slots(nbit, subblock, unpack)
    gps = subblock // P // 8                   # byte rows per subblock
    G = bp.shape[0]
    N = G * 8 * P                              # stored codes, pads included
    m_real = _cdiv(N, subblock)
    if cap is None:
        cap = 512
    qi = strict_signs(q_signs)
    nv = N if n_valid is None else int(n_valid)
    dev = qi.device

    if m_real <= cap:
        # fewer subblocks than the candidate budget: a dense rescore of the
        # unpacked gallery
        sim = qi.float() @ unpack_bitplane(bp).reshape(N, nbit).float().t()
        dist = 0.5 * (nbit - sim)
        dist = torch.where(torch.arange(N, device=dev) < nv, dist,
                           float("inf"))
        d, idx = smallest(dist, k)
        return d, idx, True

    large_m = m_real > _INNER_DIRECT_MAX
    mdt = torch.bfloat16 if nbit <= 128 else torch.float32
    # byte-pad codes are all-negative (real-looking): mask their rows in the
    # mins too when n_valid is a plain int
    nr = G * 8
    if isinstance(n_valid, int):
        nr = min(nr, _cdiv(n_valid, P))
    # (Q, m_pad) with the pad columns at nbit + 1, and the superblock mins,
    # as the selection reads them
    mins, msb = _mins_bitplane(qi, bp, nr, subblock, m_real, mdt,
                               superblocks=large_m)
    sub2 = _SUB2
    if not large_m:
        mins = mins[:, :m_real]

    # the query's byte for lane l: 0xFF iff its bit l % nbit is set (a byte
    # holds that lane of 8 codes, one per plane)
    lane_bit = torch.arange(128, device=dev) % nbit
    qb = ((qi[:, lane_bit] > 0).to(torch.uint8) * 255).to(torch.uint8)

    def select_rescore(cap_i: int):
        if not large_m:
            mv, sel_all = smallest(mins, cap_i + 1)
            sel = sel_all[:, :cap_i]
            theta_next = mv[:, cap_i]
        else:
            sel, theta_next = _approx_smallest_rows(
                mins, cap_i, sub2=sub2, return_theta=True, mins2=msb)
        rows = (sel[:, :, None] * subblock
                + torch.arange(subblock, device=dev)).reshape(Q, cap_i * subblock)
        # whole subblocks as gps consecutive byte rows; rows past the stored
        # ones (a ragged last subblock) hold codes >= N >= n_valid, which the
        # mask below sends to +inf
        g_idx = (sel[:, :, None] * gps
                 + torch.arange(gps, device=dev)).reshape(-1).clamp(max=G - 1)
        gath = bp.index_select(0, g_idx).reshape(Q, cap_i * gps, 128)
        # (byte row, plane, slot) order is the in-subblock code order:
        # code (8 * g_local + j) * P + p
        dist_c = _bitplane_rescore(gath, qb, nbit).float().reshape(
            Q, cap_i * subblock)
        dist_c = torch.where(rows >= nv, float("inf"), dist_c)
        d, li = smallest(dist_c, k)
        idx = torch.gather(rows, 1, li)
        valid = bool((d[:, -1] < theta_next).all())
        return d, idx, valid

    d1, i1, v1 = select_rescore(cap)
    # m_real - 1: the direct branch selects cap_i + 1 mins per row
    cap_retry = min(retry_mult * cap, m_real - 1)
    if v1 or cap_retry <= cap:
        return d1, i1, v1
    return select_rescore(cap_retry)

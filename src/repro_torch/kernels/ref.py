"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

The wrappers in :mod:`.ops` run these for CPU tensors; ``chip_smoke.py`` holds
each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from . import randk as _randk


# How the CUDA kernel cuts A [n, m, d] into chunks of consecutive rows of one
# worker, one thread block each: at most L1_TARGET_BLOCKS blocks in all where
# n allows (on an H100, about 2 of the kernel's 4 blocks an SM: at n = 10 that
# streamed faster than 4, and the sum pass has half the chunks to add), at
# most L1_MAX_CHUNKS a worker (the sum pass adds a worker's chunks one after
# another). The summation order of g follows from the chunks, so they are a
# function of the shapes alone, never of the card.
L1_TARGET_BLOCKS = 256
L1_MAX_CHUNKS = 128


def chunk_rows(n: int, m: int) -> int:
    """Rows of A per chunk of the l1_subgrad kernel for n workers of m rows;
    the last chunk of a worker holds the rest (ceil(m / C) chunks)."""
    per_worker = max(1, min(L1_MAX_CHUNKS, L1_TARGET_BLOCKS // max(n, 1)))
    return max(1, -(-m // per_worker))


def l1_subgrad_ref(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """g = A^T sign(A x) with sign(0) = +1 and sign(NaN) = -1.

    A: [m, d] with x: [d], or batched A: [n, m, d] with X: [n, d].

    The sum over rows is taken in the CUDA kernel's order: from 0, row by row
    inside each chunk of C = chunk_rows(n, m) rows, then the chunks' sums in
    chunk order, from 0. Where the signs agree, the result is then bit-equal
    to the kernel's on any device, so a CPU run and a card run see the same
    g. (On the paper's problem g has many coordinates that are tiny rounding
    residues, and whether a message coordinate is exactly zero, which the
    bit ledger counts, depends on their last bits.) The ragged last chunk is
    padded with zero rows: adding +0.0 to a sum that started at +0.0 leaves
    it as it is.
    """
    if A.dim() == 2:
        return l1_subgrad_ref(A.unsqueeze(0), X.unsqueeze(0))[0]
    n, m, d = A.shape
    s = torch.where(torch.matmul(A, X.unsqueeze(-1)) >= 0, 1.0, -1.0).to(A.dtype)  # [n, m, 1]
    C = chunk_rows(n, m)
    nc = -(-m // C)
    terms = torch.nn.functional.pad(s * A, (0, 0, 0, nc * C - m)).reshape(n, nc, C, d)  # exact
    part = torch.zeros((n, nc, d), dtype=A.dtype, device=A.device)
    for r in range(C):
        part = part + terms[:, :, r]
    G = torch.zeros((n, d), dtype=A.dtype, device=A.device)
    for c in range(nc):
        G = G + part[:, c]
    return G


def _topk_keep_ref(xb: torch.Tensor, k: int) -> torch.Tensor:
    """The keep mask [nblocks, block] of the Pallas kernels' block top-k
    selection over the rows of ``xb`` (see :func:`block_topk_ref`)."""
    block = xb.shape[-1]
    remaining = xb.abs().to(torch.float32)
    idx = torch.arange(block, device=xb.device)
    keep = torch.zeros(xb.shape, dtype=torch.bool, device=xb.device)
    for _ in range(min(k, block)):  # rounds past b repeat the last: no-ops
        m = remaining.amax(dim=-1, keepdim=True)
        first = torch.where(remaining == m, idx, block).amin(dim=-1, keepdim=True)
        sel = idx == first
        sel_f = sel.to(torch.float32)
        remaining = remaining * (1.0 - sel_f) - sel_f
        keep |= sel
    return keep


def block_topk_ref(x: torch.Tensor, *, k_per_block: int, block: int) -> torch.Tensor:
    """Per-block magnitude top-k with the Pallas kernel's arithmetic.

    Mirrors ``repro/kernels/topk.py::_topk_block_kernel`` operation for
    operation, not ``lax.top_k``: k rounds of a NaN-propagating block max,
    the first index among the maxima, then ``remaining*(1-sel) - sel``. On
    finite input this is ``lax.top_k``'s first-index selection. Once a NaN
    sits in ``remaining`` (a NaN input, or an inf that was selected, since
    ``inf*0`` is NaN) the max is NaN, no index equals it and no further
    coordinate is kept. ``x``: [d] with d % block == 0; output in x's dtype,
    kept coordinates bit-exact and the rest +0.0.
    """
    d = x.shape[-1]
    if d % block:
        raise ValueError(f"d={d} is not a multiple of block={block}")
    xb = x.reshape(-1, block)
    keep = _topk_keep_ref(xb, k_per_block)
    return torch.where(keep, xb, torch.zeros((), dtype=x.dtype, device=x.device)).reshape(d)


# ---------------------------------------------------------------------------
# wire: bit packing and stream extraction
#
# Bit patterns are held in int32 tensors (the uint32 pattern, reinterpreted)
# and computed in int64 masked to 32 bits: torch on the CPU has no uint32
# right shift. The float -> fp16/bf16 conversions are bitwise, never a cast:
# torch's CPU bf16 cast turns every NaN into 0xffff and casts quiet a
# signalling NaN, while the wire follows numpy's and ml_dtypes' host rules
# (see repro_torch/wire/sparse.py).
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def as_i32(v: torch.Tensor) -> torch.Tensor:
    """int32 tensor holding the uint32 patterns of ``v`` (int64 in [0, 2**32))."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def u32(t: torch.Tensor) -> torch.Tensor:
    """int64 tensor of the uint32 patterns held in an int32/int64 tensor."""
    return t.to(torch.int64) & _M32


def f32_to_f16_bits_ref(b: torch.Tensor) -> torch.Tensor:
    """numpy's ``npy_floatbits_to_halfbits`` on int64 fp32 patterns."""
    sgn = (b >> 16) & 0x8000
    fexp = b & 0x7F800000
    fsig = b & 0x007FFFFF
    nan = 0x7C00 + (fsig >> 13)
    nan = torch.where(nan == 0x7C00, 0x7C01, nan)
    big = torch.where((fexp == 0x7F800000) & (fsig != 0), nan, 0x7C00)
    ssig = (0x00800000 + fsig) >> (113 - torch.clamp(fexp >> 23, 102, 113))
    ssig = ssig + torch.where(((ssig & 0x3FFF) != 0x1000) | ((b & 0x7FF) != 0), 0x1000, 0)
    small = torch.where(fexp < 0x33000000, 0, ssig >> 13)
    nsig = fsig + torch.where((fsig & 0x3FFF) != 0x1000, 0x1000, 0)
    normal = ((fexp - 0x38000000) >> 13) + (nsig >> 13)
    h = torch.where(fexp >= 0x47800000, big, torch.where(fexp <= 0x38000000, small, normal))
    return sgn + h


def f32_to_bf16_bits_ref(b: torch.Tensor) -> torch.Tensor:
    """ml_dtypes' fp32 -> bf16 on int64 fp32 patterns: round to nearest even,
    a NaN to ``sign | 0x7FC0``."""
    rne = (b + 0x7FFF + ((b >> 16) & 1)) >> 16
    return torch.where((b & 0x7FFFFFFF) > 0x7F800000, ((b >> 16) & 0x8000) | 0x7FC0, rne)


def wire_bits_ref(b: torch.Tensor, mag: int) -> torch.Tensor:
    """Wire-dtype pattern (int64) of int64 fp32 patterns; ``mag`` is a
    ``wire.MagDType`` (0 fp32, 1 fp16, 2 bf16)."""
    if mag == 0:
        return b
    return f32_to_f16_bits_ref(b) if mag == 1 else f32_to_bf16_bits_ref(b)


def sparse_streams_ref(x: torch.Tensor, mag: int):
    """(sign, magnitude, valid) streams of fp32 ``x`` [..., d] as the
    reference's ``_emit_stream_bits`` computes them, on bit patterns: sign =
    bit 31, magnitude = the wire-dtype pattern of |x| (bits & 0x7FFFFFFF),
    valid = magnitude bits != 0. int32 tensors of x's shape."""
    b = u32(x.contiguous().view(torch.int32))
    mb = b & 0x7FFFFFFF
    return as_i32(b >> 31), as_i32(wire_bits_ref(mb, mag)), (mb != 0).to(torch.int32)


def dense_bits_ref(x: torch.Tensor, mag: int) -> torch.Tensor:
    """The wire-dtype bit pattern of each fp32 value, sign kept (int32)."""
    return as_i32(wire_bits_ref(u32(x.contiguous().view(torch.int32)), mag))


def pack_bits_ref(values: torch.Tensor, width: int) -> torch.Tensor:
    """Pack the low ``width`` bits of each value of ``values`` [..., n]
    LSB-first into little-endian 32-bit words [..., ceil(n*width/32)]
    (``wire/bitstream.py``'s layout); int32 words."""
    v = u32(values) & ((1 << width) - 1)
    n = v.shape[-1]
    nw = -(-n * width // 32)
    pos = torch.arange(n, device=v.device) * width
    s = v << (pos & 31)  # < 2**63: width + 31 <= 63 bits
    out = torch.zeros(v.shape[:-1] + (nw + 1,), dtype=torch.int64, device=v.device)
    out.index_add_(-1, pos >> 5, s & _M32)  # disjoint bit ranges: add == or
    out.index_add_(-1, (pos >> 5) + 1, s >> 32)
    return as_i32(out[..., :nw])


def unpack_bits_ref(words: torch.Tensor, width: int, count: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits_ref`: ``count`` values of ``width`` bits
    from ``words`` [..., nw] (words past the end read as 0); int32."""
    w = u32(words)
    need = -(-count * width // 32) + 1
    if w.shape[-1] < need:
        w = torch.cat([w, w.new_zeros(w.shape[:-1] + (need - w.shape[-1],))], dim=-1)
    pos = torch.arange(count, device=w.device) * width
    off = pos & 31
    lo = w[..., pos >> 5] >> off
    hi = (w[..., (pos >> 5) + 1] & ((1 << off) - 1)) << (32 - off)  # the low `off` bits: no overflow
    return as_i32((lo | hi) & ((1 << width) - 1))


# ---------------------------------------------------------------------------
# the counter hash, BernK, RotK and the fused encode streams
# ---------------------------------------------------------------------------


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2**32 for int64 h in [0, 2**32) and a constant m < 2**32,
    with no product above 2**48 (an int64 product of two 32-bit values would
    overflow)."""
    return (h * (m & 0xFFFF) + (((h * (m >> 16)) & 0xFFFF) << 16)) & _M32


def hash_uniform_ref(idx: torch.Tensor, salt) -> torch.Tensor:
    """The counter hash of ``randk.hash_uniform`` on tensors: int64 ``idx``
    (the global index) and ``salt`` = ``randk.hash_salt(seed, worker)`` (an
    int, or an int64 tensor broadcasting against idx); float32 in [0, 1),
    bit-equal to the numpy version. int64 arithmetic masked to 32 bits: torch
    on the CPU has no uint32 right shift."""
    h = _mul32(idx & _M32, _randk._M1) ^ salt
    h = h ^ (h >> 15)
    h = _mul32(h, _randk._M2)
    h = h ^ (h >> 13)
    h = _mul32(h, _randk._M1)
    h = h ^ (h >> 16)
    return h.to(torch.float32) * (1.0 / 4294967296.0)  # exact: h < 2**32, RNE to f32


def _bernk_uniform(d: int, salt, device) -> torch.Tensor:
    return hash_uniform_ref(torch.arange(d, dtype=torch.int64, device=device), salt)


def bernk_ref(x: torch.Tensor, *, keep_prob: float, seed: int, worker: int = 0) -> torch.Tensor:
    """BernK with the arithmetic of the reference's kernel
    (``repro.kernels.ops.bernk``), not of its oracle
    (``repro.kernels.ref.bernk_ref``, which divides): keep x[j] where
    ``u_j < float32(keep_prob)``, u from the counter hash of (seed, worker,
    j); in f32 the kept value is
    ``x * (float32(1) / float32(keep_prob))`` (XLA folds the Pallas body's
    division by the constant into this product), in bf16 it is
    ``bf16(float32(x) / float32(bf16(keep_prob)))`` (an f32 division, bf16 by
    round to nearest even, NaN -> sign | 0x7FC0); the rest +0.0. x: [d]."""
    kp, recip, kpb = _randk.keep_prob_constants(keep_prob)
    keep = _bernk_uniform(x.shape[-1], _randk.hash_salt(seed, worker), x.device) < kp
    if x.dtype == torch.float32:
        return torch.where(keep, x * recip, 0.0)
    # a divisor tensor on x's device: with a Python scalar, torch on CUDA
    # multiplies by its reciprocal instead of dividing
    q = x.to(torch.float32) / x.new_full((), kpb, dtype=torch.float32)
    hb = f32_to_bf16_bits_ref(u32(q.view(torch.int32)))
    hb = torch.where(keep, hb, 0)
    return torch.where(hb >= 2**15, hb - 2**16, hb).to(torch.int16).view(torch.bfloat16)


def _to16(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``v`` rounded once to ``dtype`` (fp16 / bf16) on bit patterns:
    nearest even, a NaN as numpy (fp16) / ml_dtypes (bf16) make it, whatever
    the device's own cast would do."""
    b = u32(v.view(torch.int32))
    h = f32_to_f16_bits_ref(b) if dtype == torch.float16 else f32_to_bf16_bits_ref(b)
    return torch.where(h >= 2**15, h - 2**16, h).to(torch.int16).view(dtype)


def block_coords(s: int, block, device) -> torch.Tensor:
    """The leaf coordinates of a block's ``s`` columns under ``block`` =
    (chunk, stride, offset): ``offset + (t // chunk) * stride + t % chunk``
    (None: ``t``)."""
    t = torch.arange(s, device=device)
    if block is None:
        return t
    chunk, stride, offset = block
    return offset + torch.div(t, chunk, rounding_mode="floor") * stride + t % chunk


def _rotk_ref(w: torch.Tensor, delta: torch.Tensor, rotation: torch.Tensor, n: int,
              workers, block=None) -> torch.Tensor:
    """w + Q(delta) with the kept residue (workers + r) mod n of the int32
    sum: ``workers`` an int for a [d] w, an int32 tensor [R] for w [R, d];
    column t at leaf coordinate :func:`block_coords`."""
    r = rotation.reshape(()).to(torch.int32)
    keep = block_coords(w.shape[-1], block, w.device) % n == torch.remainder(r + workers, n)[..., None]
    if w.dtype == torch.float32:
        return w + torch.where(keep, delta * float(n), 0.0)
    q = _to16(delta.float() * float(n), w.dtype).float()
    return _to16(w.float() + torch.where(keep, q, 0.0), w.dtype)


def rotk_apply_ref(w: torch.Tensor, delta: torch.Tensor, rotation: torch.Tensor, *, n: int,
                   worker: int) -> torch.Tensor:
    """w + where(j mod n == (worker + r) mod n, delta * n, +0.0), as the
    reference kernel computes it: a floor mod (r may be negative), the
    product rounded before the sum (no FMA), and -0.0 in w turned into +0.0
    where nothing is added. ``rotation``: a one-element int32 tensor r.

    fp16 / bf16 (XLA computes each 16-bit operation in fp32 and rounds it):
    q = T(f32(delta) * n), then T(f32(w) + f32(q)), each rounded once to
    nearest even (:func:`_to16`); the widening casts are exact."""
    return _rotk_ref(w, delta, rotation, n, worker)


def rotk_apply_rows_ref(w: torch.Tensor, delta: torch.Tensor, rotation: torch.Tensor, *,
                        n: int, block=None) -> torch.Tensor:
    """[R, s]: row i is :func:`rotk_apply_ref` of w[i] with worker i, as the
    reference downlink's vmap over the workers computes it (w [R, s], which
    may be one row broadcast; delta [s]). ``block`` = (chunk, stride,
    offset): the s columns are a rank's block of a leaf, column t its
    coordinate ``offset + (t // chunk) * stride + t % chunk``, which the kept
    rule reads (the same values as the whole leaf's row at those columns)."""
    return _rotk_ref(w, delta, rotation, n, torch.arange(w.shape[0], dtype=torch.int32, device=w.device),
                     block)


def mask_streams_ref(x: torch.Tensor, workers: torch.Tensor, keep_prob: float, seed: int, mag: int):
    """(sign, magnitude, valid) int32 streams [rows, d] of the BernK message
    of fp32 ``x`` [d] for each worker id in ``workers`` [rows] (int32/int64),
    as the reference's fused ``_mask_streams_kernel`` makes them: the mask
    and f32 scaling of :func:`bernk_ref`, then :func:`sparse_streams_ref`."""
    kp, recip, _ = _randk.keep_prob_constants(keep_prob)
    salt = (_mul32(u32(workers.reshape(-1, 1)), _randk._M2) + seed % 2**32) & _M32
    keep = _bernk_uniform(x.shape[-1], salt, x.device) < kp
    return sparse_streams_ref(torch.where(keep, x * recip, 0.0), mag)


def topk_streams_ref(x: torch.Tensor, k: int, block: int, mag: int):
    """(index, sign, magnitude, valid) int32 streams [nblocks, ks] of the
    reference's fused ``_topk_streams_kernel``, ks = min(k, block) slots per
    block: :func:`block_topk_ref`'s selection over fp32 ``x`` [nblocks *
    block], then each kept value in the slot of its rank inside its block
    (ascending index), with its global index; unused slots are zero."""
    d = x.shape[-1]
    if d % block:
        raise ValueError(f"d={d} is not a multiple of block={block}")
    xb = x.reshape(-1, block)
    keep = _topk_keep_ref(xb, k)
    ks = min(k, block)
    dest = torch.where(keep, torch.cumsum(keep, dim=1) - 1, ks)  # dropped -> a spare column
    gidx = torch.arange(d, device=x.device).reshape(xb.shape)
    bits = u32(xb.contiguous().view(torch.int32))
    out = torch.zeros((2,) + xb.shape[:1] + (ks + 1,), dtype=torch.int64, device=x.device)
    out.scatter_(2, dest.expand(2, *dest.shape), torch.stack([gidx, bits]))
    idx, vbits = out[..., :ks]
    sign, magbits, valid = sparse_streams_ref(as_i32(vbits).view(torch.float32), mag)
    return as_i32(idx), sign, magbits, valid

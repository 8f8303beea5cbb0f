"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

The wrappers in :mod:`.ops` run these for CPU tensors; ``chip_smoke.py`` holds
each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch


# Rows of A one block of the CUDA kernel stages in shared memory: as many as
# fit 48 KB (no opt-in needed), at most 32; one row needs 4*d bytes.
TILE_BYTES = 48 * 1024
MAX_ROWS = 32


def rows_per_block(d: int) -> int:
    return max(1, min(MAX_ROWS, TILE_BYTES // (4 * d)))


def l1_subgrad_ref(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """g = A^T sign(A x) with sign(0) = +1 and sign(NaN) = -1.

    A: [m, d] with x: [d], or batched A: [n, m, d] with X: [n, d].

    The sum over rows is taken in the CUDA kernel's order: within each block
    of R = rows_per_block(d) rows in row order, then over the blocks in
    order. Where the signs agree, the result is then bit-equal to the
    kernel's on any device, so a CPU run and a card run see the same g. (On
    the paper's problem g has many coordinates that are tiny rounding
    residues, and whether a message coordinate is exactly zero, which the
    bit ledger counts, depends on their last bits.)
    """
    if A.dim() == 2:
        return l1_subgrad_ref(A.unsqueeze(0), X.unsqueeze(0))[0]
    n, m, d = A.shape
    s = torch.where(torch.matmul(A, X.unsqueeze(-1)) >= 0, 1.0, -1.0).to(A.dtype)  # [n, m, 1]
    R = rows_per_block(d)
    G = torch.zeros((n, d), dtype=A.dtype, device=A.device)
    for r0 in range(0, m, R):
        part = s[:, r0] * A[:, r0]
        for r in range(r0 + 1, min(r0 + R, m)):
            part = part + s[:, r] * A[:, r]
        G = G + part
    return G


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
    remaining = xb.abs().to(torch.float32)
    idx = torch.arange(block, device=x.device)
    keep = torch.zeros(xb.shape, dtype=torch.bool, device=x.device)
    for _ in range(min(k_per_block, block)):  # rounds past b repeat the last: no-ops
        m = remaining.amax(dim=-1, keepdim=True)
        first = torch.where(remaining == m, idx, block).amin(dim=-1, keepdim=True)
        sel = idx == first
        sel_f = sel.to(torch.float32)
        remaining = remaining * (1.0 - sel_f) - sel_f
        keep |= sel
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

"""``ops.rotk_apply_rows`` (the R replicas of a leaf in one launch, row i
worker i) against the Pallas kernel of the JAX reference in interpret mode,
row by row, bit for bit, as tests/test_torch_kernels.py holds ``rotk_apply``;
its checks; and the perm downlink on it, against the per-worker path it
replaced (one ``rotk_apply`` a worker and leaf, copied into the rows).

On the CPU the wrapper runs its plain version (``ref.rotk_apply_rows_ref``);
the CUDA kernel is held against that plain version on the card
(tests/test_torch_kernels.py's ``cuda`` tests and chip_smoke.py)."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch import configs as TCFG  # noqa: E402
from repro_torch.kernels import ops, runtime  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.train import downlink as TD  # noqa: E402

S = 61  # columns of a leaf: odd, not a multiple of a 16-byte vector in any dtype
OFFSETS = (0, 1, 3, 8)  # column offsets of the leaf inside a wider [R, S + 8] matrix
DTYPES = {"float32": (torch.float32, jnp.float32), "float16": (torch.float16, jnp.float16),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# +-0, +-inf, NaNs of both signs and values whose product overflows fp16
CORNERS = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 65504.0, -65504.0, 3.0e4, 1e-3],
                   np.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def _torch(a, tdt) -> torch.Tensor:
    """A jax array as a torch tensor of ``tdt``, bit for bit."""
    a = np.asarray(a)
    if tdt == torch.float32:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.view(np.int16).copy()).view(tdt)


def _inputs(n, dtype):
    """(w [n, S + 8], delta [S + 8]) in the dtype, as jax arrays: standard
    normal, -0.0 in w, the corners in w and in kept and dropped columns of
    delta."""
    rng = np.random.default_rng(n)
    w = rng.standard_normal((n, S + 8)).astype(np.float32)
    w[:, 2::5] = -0.0
    delta = rng.standard_normal(S + 8).astype(np.float32)
    w[n // 2, 20:20 + CORNERS.size] = CORNERS
    delta[40:40 + CORNERS.size] = CORNERS[::-1]
    jdt = DTYPES[dtype][1]
    return jnp.asarray(w).astype(jdt), jnp.asarray(delta).astype(jdt)


def _pallas_rows(w_rows, delta, r, n):
    """Row i: the Pallas kernel on w_rows[i] with worker i."""
    return [np.asarray(jops.rotk_apply(w_rows[i], delta, jnp.int32(r), n=n, worker=i))
            for i in range(len(w_rows))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1, 3, 4, 7, 10, 16])
def test_rotk_apply_rows_vs_pallas(dtype, n):
    """R = n and R = 1, r in {-3, 0, n + 1}, w and out strided [R, S] views of
    wider matrices at column offsets 0, 1, 3 and 8 (written in place, the
    columns around them untouched), and a row-stride-0 w (one row
    broadcast, as the downlink's messages pass a zero replica)."""
    tdt = DTYPES[dtype][0]
    wj, dj = _inputs(n, dtype)
    wt, dt = _torch(wj, tdt), _torch(dj, tdt)
    for r in (-3, 0, n + 1):
        rot = torch.tensor([r], dtype=torch.int32)
        for c in OFFSETS:
            want = np.stack(_pallas_rows(wj[:, c:c + S], dj[c:c + S], r, n))
            wide = torch.full((n, S + 8), 7.0, dtype=tdt)
            out = wide[:, c:c + S]
            got = ops.rotk_apply_rows(wt[:, c:c + S], dt[c:c + S], rot, n=n, out=out)
            assert got.data_ptr() == out.data_ptr() and got.dtype == tdt
            np.testing.assert_array_equal(_bits(got), want.view(_bits(got).dtype), err_msg=f"r={r} c={c}")
            rest = torch.ones(S + 8, dtype=torch.bool)
            rest[c:c + S] = False
            assert bool((wide[:, rest] == 7.0).all())
            one = ops.rotk_apply_rows(wt[:1, c:c + S], dt[c:c + S], rot, n=n)  # R = 1: worker 0
            np.testing.assert_array_equal(_bits(one), want[:1].view(_bits(one).dtype))
        row0 = wj[0, :S]
        want = np.stack(_pallas_rows([row0] * n, dj[:S], r, n))
        got = ops.rotk_apply_rows(wt[0, :S].expand(n, S), dt[:S], rot, n=n)
        np.testing.assert_array_equal(_bits(got), want.view(_bits(got).dtype), err_msg=f"r={r} broadcast")


def test_rotk_apply_rows_checks():
    """Refused: mixed dtypes, a dtype outside f32/f16/bf16, a non-int32 or
    multi-element rotation, n < 1, more rows than workers, a non-unit column
    stride of w or out, a non-contiguous delta, mismatched shapes."""
    w, d = torch.ones(3, 8), torch.ones(8)
    rot = torch.tensor([1], dtype=torch.int32)
    for args, kw in (((w.bfloat16(), d, rot), {}), ((w.double(), d.double(), rot), {}),
                     ((w, d, rot.long()), {}), ((w, d, torch.ones(2, dtype=torch.int32)), {})):
        with pytest.raises(TypeError):
            ops.rotk_apply_rows(*args, n=4, **kw)
    bad = [((w, d, rot), {"n": 0}), ((w, d, rot), {"n": 2}),  # 3 rows > n = 2
           ((torch.ones(3, 16)[:, ::2], d, rot), {"n": 4}),
           ((w, torch.ones(16)[::2], rot), {"n": 4}),
           ((w, d, rot), {"n": 4, "out": torch.ones(3, 16)[:, ::2]}),
           ((w, d, rot), {"n": 4, "out": torch.ones(3, 9)}),
           ((w, d, rot), {"n": 4, "out": torch.ones(3, 8, dtype=torch.bfloat16)}),
           ((w, torch.ones(7), rot), {"n": 4}), ((torch.ones(8), d, rot), {"n": 4})]
    for args, kw in bad:
        with pytest.raises(ValueError):
            ops.rotk_apply_rows(*args, **kw)
    for dt in (torch.float16, torch.bfloat16):  # 16-bit: same shape and dtype out
        out = ops.rotk_apply_rows(w.to(dt)[:2], d.to(dt), rot, n=2)
        assert out.dtype == dt and out.float().tolist() == [[1.0, 3.0] * 4, [3.0, 1.0] * 4]
    runtime.reset_launches()
    ops.rotk_apply_rows(w, d, rot, n=3)
    assert sum(runtime.LAUNCHES.values()) == 0  # the CPU runs the plain version


# ---------------------------------------------------------------------------
# the perm downlink on the rows entry
# ---------------------------------------------------------------------------


def _per_worker_round(dl, draws, sizes, server_new, server_old, workers):
    """The perm round as a loop over workers and leaves: one rotk_apply a
    worker, its output copied into the worker's row."""
    new = torch.empty_like(workers)
    for li, o, s in TD._segments(sizes):
        delta = (server_new[o:o + s] - server_old[o:o + s]).to(workers.dtype)
        for i in range(dl.n_workers):
            new[i, o:o + s] = ops.rotk_apply(workers[i, o:o + s], delta, draws.rot[li:li + 1],
                                             n=dl.n_workers, worker=i)
    return new


def _per_worker_messages(dl, draws, sizes, server_new, server_old):
    Q = torch.zeros((dl.n_workers, sum(sizes)), dtype=torch.float32)
    for li, o, s in TD._segments(sizes):
        delta = (server_new[o:o + s] - server_old[o:o + s]).float()
        for i in range(dl.n_workers):
            Q[i, o:o + s] = ops.rotk_apply(torch.zeros_like(delta), delta, draws.rot[li:li + 1],
                                           n=dl.n_workers, worker=i)
    return Q


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_workers", [3, 4])
def test_perm_downlink_rows_equal_per_worker_path(monkeypatch, dtype, n_workers):
    """``MarinaPDownlink.round`` and ``messages`` (perm) at gemma3-1b's smoke
    sizes equal the per-worker path bit for bit (-0.0 in the replicas, exact
    zeros in the delta, rotations of every residue), with one rotk_apply_rows
    call a leaf and no rotk_apply call."""
    sizes = TP.leaf_sizes(TLM.lm_spec(TCFG.get_smoke("gemma3-1b")))
    d = sum(sizes)
    rng = np.random.default_rng(n_workers)
    server_old = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    step = rng.standard_normal(d) * 1e-3 * (rng.random(d) < 0.9)
    server_new = server_old + torch.from_numpy(step.astype(np.float32))
    workers = (server_old + torch.from_numpy((rng.standard_normal((n_workers, d)) * 1e-3)
                                             .astype(np.float32))).to(dtype)
    workers[:, ::97] = -0.0
    rot = torch.from_numpy(rng.integers(0, n_workers, len(sizes)).astype(np.int32))
    draws = TD.DownlinkDraws(rot=rot)
    dl = TD.MarinaPDownlink(n_workers=n_workers, mode="perm")
    want = _per_worker_round(dl, draws, sizes, server_new, server_old, workers)
    want_q = _per_worker_messages(dl, draws, sizes, server_new, server_old)

    calls = []
    rows = ops.rotk_apply_rows
    monkeypatch.setattr(ops, "rotk_apply_rows", lambda *a, **k: calls.append(1) or rows(*a, **k))
    monkeypatch.setattr(ops, "rotk_apply", lambda *a, **k: pytest.fail("per-worker rotk_apply call"))
    got, _ = dl.round(draws, sizes, server_new, server_old, workers)
    assert len(calls) == len(sizes) and got.dtype == dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))
    got_q = dl.messages(draws, sizes, server_new, server_old)
    assert len(calls) == 2 * len(sizes)
    np.testing.assert_array_equal(_bits(got_q), _bits(want_q))

"""The port stands alone: it runs with JAX and ml_dtypes unimportable,
imports nothing of the JAX package ``repro``, and its entry points never
default to the CPU."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

# `import jax`, `from jax...`, `import ml_dtypes` (it comes with JAX),
# `import repro`/`repro.x`, `from repro(.x) import`; `repro_torch` does not match.
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+ml_dtypes\b|from\s+ml_dtypes\b"
                       r"|import\s+repro\b(?!_)|from\s+repro\b(?!_))")

JAX_FREE_RUN = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["ml_dtypes"] = None
import repro_torch
from repro_torch.core import marina_p, problems, stepsizes
prob = problems.generate_problem(n=4, d=32, noise_scale=1.0, seed=0, device="cpu")
h = marina_p.run(prob, mode="perm", k=8, p=0.25, stepsize=stepsizes.Constant(0.01), T=3)
assert h["ledger"].rounds == 3, h["ledger"].rounds
# the wire path, bf16 magnitudes, on the CPU problem: no ml_dtypes needed
h = marina_p.run(prob, mode="ind", k=8, p=0.25, stepsize=stepsizes.Constant(0.01), T=3,
                 measure_wire=True, wire_mag="bf16")
assert len(h["wire_bits"]) == 3 and h["wire_bits_total"] > 0, h["wire_bits"]
# the encode and kernel benchmarks' modules: bernk, rotk_apply, the fused
# encoders, the new compressors and the NATURAL codec
import torch
from repro_torch import kernel_bench, wire, wire_bench
from repro_torch.core import compressors as C
from repro_torch.kernels import encode as K, ops
x = torch.linspace(-1.0, 1.0, 300)
assert K.mask_encode(x, keep_prob=0.1, seed=3) == wire.encode_sparse(ops.bernk(x, keep_prob=0.1, seed=3))
assert K.topk_encode(x, k_per_block=8, block=128) == wire.encode_sparse(ops.block_topk(x, k_per_block=8, block=128))
assert len(K.encode_per_worker(x, n_workers=3, keep_prob=0.5, seed=1)) == 3
ops.rotk_apply(x, x, torch.tensor(1, dtype=torch.int32), n=3, worker=0)
gen = torch.Generator().manual_seed(0)
for comp in (C.RotK(n=3), C.BernK(k=30), C.NaturalCompression(), C.ScaledUnbiased(inner=C.RandK(k=30))):
    q = comp(x, comp.draw(300, gen, "cpu"))
    wire.encode(q, comp)
assert wire_bench.bench_encode(d=256, device="cpu")[-1][2] == 1.0
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
print("ok")
"""


def test_port_runs_without_jax_and_without_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", JAX_FREE_RUN], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_no_file_of_the_port_imports_jax_or_repro():
    assert len(PORT_FILES) > 10
    offenders = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
                 for p in PORT_FILES
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if FORBIDDEN.match(line)]
    assert not offenders, offenders


def test_forbidden_pattern_itself():
    assert FORBIDDEN.match("import jax") and FORBIDDEN.match("  from jax.numpy import x")
    assert FORBIDDEN.match("from repro.core import problems") and FORBIDDEN.match("import repro")
    assert FORBIDDEN.match("import ml_dtypes") and FORBIDDEN.match("from ml_dtypes import bfloat16")
    assert not FORBIDDEN.match("from repro_torch.core import problems")
    assert not FORBIDDEN.match("import repro_torch") and not FORBIDDEN.match("import jaxlib_x")


def test_default_device_is_the_card():
    """Without CUDA, the default device="cuda" raises; it never returns CPU
    tensors."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from repro_torch import convert
    from repro_torch.core import problems

    with pytest.raises(RuntimeError, match="cuda"):
        problems.generate_problem(n=2, d=8, noise_scale=1.0)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.ef21p_state_from_numpy([0.0], [0.0], 0)

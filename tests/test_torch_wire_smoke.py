"""``python -m repro_torch.wire_bench --smoke``: the reference's smoke
sizes (``benchmarks/wire_bench.py --smoke``: codec throughput at d = 2**16,
the fused-encode roofline at 2**14, parity at d = 256, n = 4, T = 30) and
its exit rules (1 on a byte mismatch or on a MARINA-P gap of 5% or more)."""
import pytest
import torch

from repro_torch import wire_bench


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def recorded(monkeypatch, parity=None, identical=1.0):
    """Stub every section; record the sizes each is called with."""
    calls = []
    monkeypatch.setattr(wire_bench, "throughput_rows",
                        lambda *, d, device: calls.append(("throughput", d)) or [])
    monkeypatch.setattr(wire_bench, "encode_roofline_rows",
                        lambda *, d, device: calls.append(("roofline", d)) or [])
    monkeypatch.setattr(wire_bench, "bench_encode",
                        lambda *, device: [("encode/byte_identical", 1.0, identical)])
    monkeypatch.setattr(wire_bench, "parity_rows", lambda *, d, n, T, device: calls.append(("parity", d, n, T))
                        or (parity or [("marina_p/same", 100.0, 101.0, 1.0)]))
    return calls


@pytest.mark.parametrize("argv,want", [
    (["--smoke"], [("throughput", 2**16), ("roofline", 2**14), ("parity", 256, 4, 30)]),
    (["--smoke", "--T", "7"], [("throughput", 2**16), ("roofline", 2**14), ("parity", 256, 4, 7)]),
    ([], [("throughput", 2**20), ("roofline", 2**16), ("parity", 1024, 4, 200), ("parity", 1000, 10, 200)]),
], ids=["smoke", "smoke-T-wins", "full"])
def test_sizes_are_the_reference(monkeypatch, argv, want):
    calls = recorded(monkeypatch)
    assert wire_bench.main([*argv, "--device", "cpu"]) == 0
    assert calls == want


@pytest.mark.parametrize("pct,identical,rc", [(4.99, 1.0, 0), (5.0, 1.0, 1), (-7.5, 1.0, 1), (1.0, 0.0, 1)])
def test_exit_rules(monkeypatch, capsys, pct, identical, rc):
    recorded(monkeypatch, parity=[("marina_p/ind", 100.0, 100.0 + pct, pct),
                                  ("ef21p/block_topk", 100.0, 150.0, 50.0)], identical=identical)
    assert wire_bench.main(["--smoke", "--device", "cpu"]) == rc
    assert ("FAILURES" in capsys.readouterr().err) == bool(rc)


def test_smoke_exits_0_on_the_cpu(one_thread, capsys):
    assert wire_bench.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "d=2**16" in out and "d=2**14" in out and "d=256 n=4 T=30" in out
    assert "byte identity OK; parity OK" in out

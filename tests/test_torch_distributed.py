"""The port's SPMD rounds (repro_torch.core.distributed on torch.distributed)
== the port's single-process steps, as tests/test_distributed.py holds the
reference's shard_map rounds.

Four gloo ranks on the CPU in a subprocess (torch.multiprocessing.spawn, a
``file://`` rendezvous), n = 8 workers, d = 64: MARINA-P in all three modes
(constant and Polyak stepsizes; perm also at d = 66, where worker 0 takes the
leftover coordinates) within 1e-4 of ``marina_p.make_step`` over 8 rounds fed
the same ``MarinaPDraws``, each rank holding its two workers' W
rows; EF21-P teacher-forced per step, w compared only where the k-th
magnitude gap exceeds 1e-5 (TopK breaks exact ties by the last bit of the
worker sum, whose order differs). Needs no JAX.
"""
import os
import subprocess
import sys
import textwrap

_SCRIPT = textwrap.dedent(
    """
    import sys
    import torch
    import torch.multiprocessing as mp

    WORLD, N, D, K, P = 4, 8, 64, 8, 0.1


    def worker(rank, init):
        import torch.distributed as dist
        from repro_torch.core import compressors, distributed as S, ef21p, marina_p, problems, stepsizes

        S.init_process_group(init, rank=rank, world_size=WORLD, device="cpu")
        group = dist.group.WORLD
        prob = problems.generate_problem(n=N, d=D, noise_scale=1.0, seed=1, device="cpu")
        A = S.shard_problem(group, prob.A, device="cpu")
        local_n = N // WORLD
        lo = rank * local_n
        assert A.shape == (local_n, D, D)
        assert torch.equal(A, prob.A[lo:lo + local_n])

        # ---- MARINA-P, all three modes ----------------------------------
        # d = 66: perm's 2 leftover coordinates go to worker 0, on rank 0
        odd = problems.generate_problem(n=N, d=66, noise_scale=1.0, seed=1, device="cpu")
        cases = [(prob, A, mode, stepsizes.Constant(gamma=0.05)) for mode in ("same", "ind", "perm")]
        cases.append((prob, A, "perm", stepsizes.MarinaPPolyak(omega=N - 1.0, p=P)))
        cases.append((odd, S.shard_problem(group, odd.A, device="cpu"), "perm", stepsizes.Constant(gamma=0.05)))
        for pr, A_local, mode, ss in cases:
            ref_step = marina_p.make_step(pr, mode, K, P, ss)
            spmd_step = S.make_marina_p_spmd_step(group, n=N, d=pr.d, mode=mode, k=K, p=P,
                                                  stepsize=ss, device="cpu")
            bcast = marina_p.make_broadcast(mode, N, K)
            gen = torch.Generator().manual_seed(42)  # the same draws on every rank
            state = marina_p.init(pr.x0, N)
            sp = S.init_marina_p(pr.x0, local_n)
            for i in range(8):
                draws = marina_p.draw_round(bcast, P, pr.d, gen, "cpu")
                state, m1 = ref_step(state, draws)
                sp, m2 = spmd_step(sp, A_local, draws)
                assert sp.t == state.t
                assert float((state.x - sp.x).abs().max()) < 1e-4, (mode, i)
                assert float((state.W[lo:lo + local_n] - sp.W).abs().max()) < 1e-4, (mode, i)
                assert abs(float(m1["gamma"]) - float(m2["gamma"])) <= 1e-4 * abs(float(m1["gamma"]))
                assert m2["q_nnz_mean"] == m1["q_nnz_mean"], (mode, i)
                assert m2["full_sync"] == m1["full_sync"]
            # the replicated iterate is the same on every rank
            xs = [torch.empty_like(sp.x) for _ in range(WORLD)]
            dist.all_gather(xs, sp.x)
            assert all(torch.equal(x, xs[0]) for x in xs)
        if rank == 0:
            print("MARINA-P SPMD OK", flush=True)

        # ---- EF21-P, teacher-forced ---------------------------------------
        ss = stepsizes.Constant(gamma=0.05)
        ref_step = ef21p.make_step(prob, compressors.TopK(k=K), ss)
        spmd_step = S.make_ef21p_spmd_step(group, n=N, d=D, k=K, stepsize=ss, device="cpu")
        state = ef21p.init(prob.x0)
        checked = 0
        for i in range(16):
            new_state, m1 = ref_step(state)
            sp, m2 = spmd_step(S.SpmdEF21PState(x=state.x, w=state.w, t=state.t), A)
            assert float((new_state.x - sp.x).abs().max()) < 1e-4, i
            mags = torch.sort((new_state.x - state.w).abs(), descending=True).values
            if float(mags[K - 1] - mags[K]) > 1e-5:  # selection unambiguous
                assert float((new_state.w - sp.w).abs().max()) < 1e-4, i
                checked += 1
            state = new_state  # teacher-force the single-process trajectory
        assert checked >= 2, checked
        if rank == 0:
            print("EF21-P SPMD OK", flush=True)

        try:  # 6 workers do not split over 4 ranks
            S.make_ef21p_spmd_step(group, n=6, d=D, k=K, stepsize=ss, device="cpu")
        except ValueError:
            pass
        else:
            raise AssertionError("n=6 over 4 ranks accepted")
        dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(worker, args=(sys.argv[1],), nprocs=WORLD, join=True)
    """
)


def test_spmd_equivalence_gloo_subprocess(tmp_path):
    script = tmp_path / "spmd.py"
    script.write_text(_SCRIPT)
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    init = f"file://{tmp_path / 'rendezvous'}"
    res = subprocess.run([sys.executable, str(script), init], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "MARINA-P SPMD OK" in res.stdout
    assert "EF21-P SPMD OK" in res.stdout

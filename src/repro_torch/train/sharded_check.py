"""Holding the sharded train step (:mod:`.sharded`) on R ranks against the
single-process step (``trainer.make_train_step``), teacher-forced: each step
starts from the single-process state of that step, so the bound is one
step's. The CPU tests (4 gloo ranks) and ``chip_smoke.py``'s 4 gloo ranks on
one card both run :func:`run_case` on every rank and :func:`hold` on its
result, with the bounds set here.

Only the order of the sums over workers (and, under ``act_spec``, over row
blocks) differs from the single-process step. The bounds are (loss, max
|dg| / max |g| with g recovered from AdamW's first moment, grad_norm's and
the drift's rel, the new master's max |diff| / lr, the share of its
coordinates past 0.1 lr). A (D, 1) mesh sums the same per-worker gradients
in another order (measured with the smoke gemma-2b on 4 CPU ranks: loss
equal, g within 1.0e-7, the master within 3e-5 lr). Under ``act_spec`` each
worker's rows are M blocks whose bf16 forward rounds elsewhere, so the
bounds are the ones held against the reference (tests/test_torch_train_step.py)
where the run needs them (measured there: loss 4.8e-7, g 6.6e-3, grad_norm
2.9e-4, the master 2.0 lr with 6.4e-4 of its coordinates past 0.1 lr).
Under tensor parallelism over "model" (the rank's blocks, M > 1, no
``act_spec``) the forward's row-parallel products sum fp32 partials in
another order than the single product, which moves some bf16 outputs by an
ulp, and the backward sums the column-parallel products' partial gradients
of x in fp32 before one rounding, where the single process rounds each
product's. Each number is held to the ``act_spec`` bound or, where wider,
:data:`FLOOR_FACTOR` times the single process's own floor measured in the
same run: the distance of the single process from itself with the
tensor-parallel step's summation order in one process (:class:`OneRank`:
the row-parallel products' M fp32 partials summed before one rounding, x's
gradient summed in fp32 and rounded once, the vocabulary-parallel CE over M
blocks), and for the loss the larger of that and :func:`loss_floor` (the
distance one rounding of the logits makes). Measured with the smoke gemma-2b on 4 CPU
ranks at (1, 4) and (2, 2): loss 1.4e-5-4.3e-5 (floor 8.8e-5-1.9e-4), g
6.5e-3, grad_norm 8.3e-4, the master 2.0 lr with 1.5e-3 past 0.1 lr.
MARINA-P's replicas are held to W times the master's bound (a kept
coordinate adds W times the master's delta) plus one bf16 ulp of their
largest value; EF21-P's shift bit for bit to the downlink of the ranks' own
gathered x^{t+1} (TopK's near-ties follow its last bit); the counters
exactly.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..data import SyntheticLMData
from ..kernels import runtime
from ..launch import op_cost
from ..launch.mesh import Mesh
from ..launch.specs import compressed_draws
from ..models import lm
from ..models import params as P
from ..optim import constant_lr, make_optimizer
from ..serve import sharded as SS
from . import downlink as D
from . import sharded as SH
from . import trainer

LR = 2e-3  # the steps' constant lr, which the bounds are in units of
DATA_BOUNDS = (1e-5, 1e-5, 1e-5, 0.01, 0.0)
ACT_BOUNDS = (1e-5, 1.1e-2, 1e-3, 2.2, 2e-3)   # 2.2 lr: two AdamW updates of opposite sign
B1 = 0.9  # AdamW's first-moment decay (make_optimizer's default)
WORST_KEYS = ("loss", "g", "server_lr", "bulk", "rows_lr", "norms")


FLOOR_FACTOR = 1.5  # tensor parallelism's bounds: at most this times the run's own floor

# smoke configs with product weights that "model" = 4 does not split, whose tensor-parallel step reads them
# whole (tests/test_torch_train_whole.py, chip_smoke.py (w2)), by "arch@variant" (:func:`variant`):
# * deepseek-v2-236b@e3: 3 experts: the router (128, 3) and the experts [3, ..] whole at M = 2 and 4, the
#   routed part alike on every rank;
# * zamba2-1.2b@n17: Mamba2's state of 17: in_proj (128, 554) and conv_w (4, 290) whole at M = 4 (split at
#   M = 2), read in part by the rank's heads;
# * gemma-2b@odd: d_ff 255 and a vocabulary of 511: the MLP and the tied embedding whole at M = 2 and 4 (the
#   MLP and the logits alike on every rank), attention on the rank's heads.
VARIANTS = ("deepseek-v2-236b@e3", "zamba2-1.2b@n17", "gemma-2b@odd")


def variant(name: str):
    """The smoke config ``arch``, or of ``arch@variant`` (:data:`VARIANTS`)."""
    from .. import configs

    arch, _, which = name.partition("@")
    cfg = configs.get_smoke(arch)
    if which == "e3":
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=3))
    if which == "n17":
        return dataclasses.replace(cfg, mamba=dataclasses.replace(cfg.mamba, state_dim=17))
    if which == "odd":
        return dataclasses.replace(cfg, d_ff=255, vocab_size=511)
    if which:
        raise ValueError(f"no variant {which!r} of {arch}")
    return cfg


class OneRank(SS.ServeShard):
    """The tensor-parallel step's arithmetic in one process, the floor of
    :func:`hold`: the shard context on a (1, 1) mesh (its column-parallel
    products sum x's gradient in fp32 before one rounding, as the ranks'
    ``enter`` does), whose row-parallel products sum ``parts`` fp32 partials
    over blocks of their rows before one rounding, as ``parts`` ranks'
    ``exit`` does, and whose loss is the vocabulary-parallel CE over
    ``parts`` vocabulary blocks (``lm.cross_entropy_tp``, where the
    vocabulary splits so): rwkv6's backward amplifies that CE's rounding
    into its grad norm (1.2e-3 at (1, 4) on the smoke config, against 6e-5
    without it). The values are the single process's, summed in another
    order."""

    def __init__(self, cfg, parts: int):
        super().__init__(cfg, SS.ServeLayout(Mesh(("data", "model"), (1, 1)), 0, "tp"), SH.CountingComm())
        self.parts = parts
        self.vocab_blocks = parts if cfg.vocab_size % parts == 0 else 1

    def row_mm(self, x, p, name):
        w = self.weight(p, name, x.dtype)
        k = w.shape[-2] // self.parts
        out = None
        for i in range(self.parts):
            xi, wi = x[..., i * k:(i + 1) * k], w[i * k:(i + 1) * k]
            part = SS._RowMm.apply(xi, wi) if torch.is_grad_enabled() else P.mm_f32(xi, wi)
            out = part if out is None else out + part
        return out.to(x.dtype)


def bounds(split: bool) -> tuple:
    """ACT_BOUNDS where a step splits over "model" (``act_spec``, or tensor
    parallelism, which :func:`hold` also holds to its floor), else DATA_BOUNDS."""
    return ACT_BOUNDS if split else DATA_BOUNDS


def loss_floor(cfg, rows, batch, *, chunk: int, window_override=None) -> float:
    """The single process's own loss floor: the largest |loss - the loss of
    the same logits before their bf16 rounding| over the workers, worker i
    at ``rows[i]`` [d] on ``batch``'s row i: the distance one rounding of
    the logits makes."""
    spec = lm.lm_spec(cfg)
    kw = dict(chunk=chunk, remat=False, window_override=window_override)
    worst = 0.0
    with torch.no_grad():
        for i, row in enumerate(rows):
            shard = {k: v[i] for k, v in batch.items()}
            tree = P.grad_tree(spec, row)
            h = lm.hidden(cfg, tree, shard, **kw)
            w = P.weight(tree, "embed" if cfg.tie_embeddings else "unembed", h.dtype).float()
            w = w.transpose(-1, -2) if cfg.tie_embeddings else w
            exact = torch.einsum("bsd,kdv->bksv", h.float(), w) if cfg.num_codebooks else h.float() @ w
            tokens = shard["tokens"]
            for lg in (lm.logits_from_hidden(cfg, tree, h), exact):
                lb = (lg[..., :-1, :], tokens[..., 1:]) if cfg.num_codebooks else (lg[:, :-1], tokens[:, 1:])
                if lg is exact:
                    worst = max(worst, abs(float(lm.cross_entropy(*lb)) - rounded))
                else:
                    rounded = float(lm.cross_entropy(*lb))
    return worst


def _g_of(opt_new, opt_old):
    # AdamW's m = (1 - b1) g + b1 m_old: the step's g, to rounding
    return (opt_new["m"] - B1 * opt_old["m"]) / (1 - B1)


def compare(full, want, m2, m1, old, rows) -> list:
    """The step's distances, in :data:`WORST_KEYS`' order, of the gathered
    sharded state ``full`` and metrics ``m2`` from the single-process ones
    (``want``, ``m1``), both from ``old``; ``rows`` the replicas to hold
    ``full``'s to. Raises where a counter differs."""
    g2, g1 = _g_of(full["opt"], old["opt"]), _g_of(want["opt"], old["opt"])
    ds = (full["server"] - want["server"]).abs()
    out = [abs(float(m2["loss"]) - float(m1["loss"])),
           float((g2 - g1).abs().max() / g1.abs().max()),
           float(ds.max()) / LR, float((ds > 0.1 * LR).float().mean()), 0.0,
           abs(float(m2["grad_norm"]) / float(m1["grad_norm"]) - 1)]
    if "workers" in want:
        fw, rw = (full["workers"], rows) if rows.dim() == 2 else (full["workers"][None], rows[None])
        out[4] = max(float((a.float() - b.float()).abs().max()) for a, b in zip(fw, rw)) / LR  # a row at a time
        a, b = float(m2["drift"]), float(m1["drift"])  # 0 after a sync
        out[5] = max(out[5], abs(a - b) / max(abs(b), 1e-30))
    for k in ("step", "bits_per_worker", "uplink_bits_per_worker"):
        if full[k] != want[k]:
            raise AssertionError(f"{k}: {full[k]} != {want[k]}")
    if full["opt"]["count"] != want["opt"]["count"]:
        raise AssertionError(f"opt count {full['opt']['count']} != {want['opt']['count']}")
    if set(m2) != set(m1) or float(m2["bits_per_worker"]) != float(m1["bits_per_worker"]):
        raise AssertionError(f"metrics {sorted(m2)} vs {sorted(m1)}")
    if float(m2["lr"]) != float(m1["lr"]):
        raise AssertionError(f"lr {float(m2['lr'])} != {float(m1['lr'])}")
    if "participants" in m1 and float(m2["participants"]) != float(m1["participants"]):
        raise AssertionError(f"participants {float(m2['participants'])} != {float(m1['participants'])}")
    return out


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def run_case(cfg, tcfg, spec: str, layout: SH.Layout, comm: SH.Comm, aux: SH.Comm, *, batch_rows: int,
             seq: int, device, steps: int = 3, forced: bool = False, check_rank=None, draw_seed: int = 11) -> dict:
    """``steps`` teacher-forced steps of the sharded step under downlink
    ``spec`` (``tcfg`` as the sharded step takes it; the single-process step
    runs it without ``act_spec``) on a [W, batch_rows, seq] synthetic batch
    from seed 1's state and ``draw_seed``'s draws, every rank calling it. Each
    step also checks that ``shard_state`` / ``gather_state`` give the state
    back bit for bit and that the bytes ``comm`` handed to the group equal
    the dry-run's count of the same step on ``meta``; a forced sync at step
    1 where ``forced`` (the count once for each kind of round: a sync, a
    forced sync, a compressed round). Returns {"worst": the largest distances
    (:data:`WORST_KEYS`), "moved": the last step's bytes by kind, "wmax":
    the replicas' largest |value|, "launches": the sharded steps' kernel
    launches, "compressed": the steps that were no sync, "floor": under
    tensor parallelism the single process's own floor, each distance's
    largest over the steps (:data:`WORST_KEYS`; see :func:`hold`), else
    None}. ``check_rank``: only that rank runs the single-process steps,
    the floor and the comparisons (of the gathered state, which holds every
    rank's share), and the others report zeros; between steps it
    broadcasts the single-process state that teacher-forces the next one
    (:func:`share_state`). One step holds the whole state on that rank
    alone, for a model whose whole state a card holds once, not on every
    rank."""
    if check_rank is not None and not 0 <= check_rank < layout.world:
        raise ValueError(f"check_rank {check_rank} outside a mesh of {layout.world} ranks")
    mine = check_rank is None or layout.rank == check_rank
    W = layout.n_workers
    sizes = P.leaf_sizes(lm.lm_spec(cfg))
    dl, opt = D.make_downlink(spec, W), make_optimizer("adamw", weight_decay=0.01)
    whole = dataclasses.replace(tcfg, act_spec=None)
    single = trainer.make_train_step(cfg, whole, dl, opt, constant_lr(LR))
    if layout.tp:  # the single process with the tensor-parallel arithmetic at one rank: the floor
        exact = trainer.make_train_step(cfg, whole, dl, opt, constant_lr(LR), tp=OneRank(cfg, layout.model_size))
    step = SH.make_sharded_train_step(cfg, tcfg, dl, opt, constant_lr(LR), layout, comm)
    counter = SH.CountingComm()
    metastep = SH.make_sharded_train_step(cfg, tcfg, dl, opt, constant_lr(LR), layout, counter)
    meta_state = SH.init_state(cfg, tcfg, dl, opt, layout, device="meta")
    plan = trainer.participation_plan(tcfg)
    state = trainer.init_state(cfg, tcfg, dl, opt, device=device, seed=1)
    data = SyntheticLMData(cfg, W, batch_rows, seq, device=str(device))
    gen, pgen = torch.Generator().manual_seed(draw_seed), torch.Generator().manual_seed(draw_seed)
    dgen = torch.Generator(device).manual_seed(draw_seed)
    worst, moved, launches, compressed = [0.0] * len(WORST_KEYS), {}, {}, 0
    counts = {}  # (sync round, forced sync) -> the meta count's (bytes the counter tallied, collectives)
    floor = [0.0] * len(WORST_KEYS)
    for i in range(steps):
        if check_rank is not None and i:
            state = share_state(state if mine else None, check_rank)
        batch = data.batch(i)
        draws = D.draw_round(dl, sizes, gen, dgen)
        if not plan.is_full:
            draws = draws._replace(part=plan.draw(W, pgen, device))
        force = forced and i == 1
        compressed += not (draws.coin or force)
        sp = SH.shard_state(state, layout)
        if not mine:
            state = None
        back = SH.gather_state(sp, layout, aux)
        if mine:
            pairs = [(back["server"], state["server"]), (back["opt"]["m"], state["opt"]["m"]),
                     (back["opt"]["v"], state["opt"]["v"])]
            if "workers" in state:
                pairs.append((back["workers"], state["workers"]))
            if not all(_bit_equal(a, b) for a, b in pairs):
                raise AssertionError(f"{spec} step {i}: gather_state(shard_state(state)) != state")
        del back
        before, l0 = dict(comm.bytes), runtime.LAUNCHES.copy()
        sp, m2 = step(sp, batch, draws, force)
        for k, v in runtime.LAUNCHES.items():  # the sharded step's own launches
            if v - l0.get(k, 0):
                launches[k] = launches.get(k, 0) + v - l0.get(k, 0)
        moved = {k: v - before.get(k, 0) for k, v in comm.bytes.items()}
        if (draws.coin, force) not in counts:  # the count on meta depends on the round's kind alone
            mdraws = D.DownlinkDraws(coin=True) if draws.coin else compressed_draws(dl, sizes)
            if not plan.is_full:
                mdraws = mdraws._replace(part=tuple(torch.empty(W, device="meta") for _ in range(2)))
            before = dict(counter.bytes)
            with op_cost.counting() as c:
                metastep(meta_state, {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                                      for k, v in batch.items()}, mdraws, force)
            counts[draws.coin, force] = ({k: v - before.get(k, 0) for k, v in counter.bytes.items()}, dict(c.coll))
        counted, coll = counts[draws.coin, force]
        if not moved == counted == coll:
            raise AssertionError(f"{spec} step {i}: bytes handed to the group {moved} != counted {counted} "
                                 f"(op count {coll})")
        if not mine:
            SH.gather_state(sp, layout, aux)  # the others' part of the check's gather
            continue
        new, m1 = single(state, batch, draws, force)
        if layout.tp:
            nf, mf = exact(state, batch, draws, force)
            got_f = compare(nf, new, mf, m1, state, new.get("workers"))
            got_f[0] = max(got_f[0], loss_floor(cfg, trainer.replica_rows(dl, state, state["server"], W), batch,
                                                chunk=tcfg.attn_chunk, window_override=tcfg.window_override))
            floor = [max(a, b) for a, b in zip(floor, got_f)]
            del nf, mf
        full = SH.gather_state(sp, layout, aux)
        rows = new.get("workers")
        if isinstance(dl, D.EF21PDownlink):
            rows, _ = dl.round(D.DownlinkDraws(), sizes, full["server"], state["workers"], force)
            if not torch.equal(full["workers"], rows):
                raise AssertionError(f"{spec} step {i}: the shift != the downlink of the ranks' own x^(t+1)")
        got = compare(full, new, m2, m1, state, rows)
        worst = [max(a, b) for a, b in zip(worst, got)]
        state = new
        del full, rows
    if sp["server"].shape != (layout.shard_len,):
        raise AssertionError(f"a rank's master slice {tuple(sp['server'].shape)}, not ({layout.shard_len},)")
    if "workers" in sp and sp["workers"].dim() == 2 and sp["workers"].shape != (layout.local, layout.d_rank):
        raise AssertionError(f"a rank's replicas {tuple(sp['workers'].shape)}, not ({layout.local}, "
                             f"{layout.d_rank})")
    wmax = float(state["workers"].float().abs().max()) if mine and "workers" in state else 0.0
    return {"worst": worst, "moved": moved, "wmax": wmax, "launches": launches,
            "floor": floor if layout.tp else None, "compressed": compressed}


def share_state(state, src: int):
    """Rank ``src``'s train state on every rank of the default group
    (``state`` there, None elsewhere): its structure and the shapes of its
    tensors in one object broadcast, then one broadcast a tensor, on the
    device ``src``'s tensors lie on."""
    from torch.utils import _pytree as pytree
    mine = dist.get_rank() == src
    if mine:
        leaves, tree = pytree.tree_flatten(state)
        meta = [(tuple(v.shape), v.dtype, str(v.device)) if isinstance(v, torch.Tensor) else ("value", v)
                for v in leaves]
        box = [pytree.treespec_dumps(tree), meta]
    else:
        box = [None, None]
    dist.broadcast_object_list(box, src=src)
    tree, meta = pytree.treespec_loads(box[0]), box[1]
    out = []
    for i, m in enumerate(meta):
        if m[0] == "value":
            out.append(m[1])
            continue
        t = leaves[i].contiguous() if mine else torch.empty(m[0], dtype=m[1], device=m[2])
        dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t, src=src)
        out.append(t)
    return pytree.tree_unflatten(out, tree)


def hold(name: str, res: dict, bnds: tuple, n_workers: int) -> None:
    """Raises unless :func:`run_case`'s result ``res`` for the case ``name``
    (a downlink spec, with "bf16" in it for bf16 replicas) is within
    ``bnds``: the master's, and MARINA-P's replicas within W times the
    master's bound plus one bf16 ulp of their largest value; under tensor
    parallelism (a ``floor`` in ``res``) each number within
    :data:`FLOOR_FACTOR` times the single process's own floor where that is
    wider."""
    loss_b, g_b, gnorm_b, server_b, bulk_b = bnds
    if res.get("floor") is not None:
        f = dict(zip(WORST_KEYS, res["floor"]))
        loss_b, g_b, gnorm_b, server_b, bulk_b = (max(b, FLOOR_FACTOR * f[k]) for b, k in zip(
            (loss_b, g_b, gnorm_b, server_b, bulk_b), ("loss", "g", "norms", "server_lr", "bulk")))
    loss, g_rel, server, bulk, rows, gnorm = res["worst"]
    ulp = 2**-8 * res["wmax"] / LR if "bf16" in name else 0.0
    rows_b = (n_workers if name.startswith("marina") else 1) * server_b + ulp
    if not (loss <= loss_b and g_rel <= g_b and gnorm <= gnorm_b and server <= server_b and bulk <= bulk_b
            and rows <= rows_b):
        raise AssertionError(f"{name}: {dict(zip(WORST_KEYS, res['worst']))} outside "
                             f"{(loss_b, g_b, gnorm_b, server_b, bulk_b)} (rows {rows_b}; floor {res.get('floor')})")

"""Per-(architecture x input shape x mesh) step specs (counterpart of
``repro/launch/specs.py``).

``build(arch_id, shape_id, mesh)`` returns the port's step function, its
abstract arguments (``meta`` tensors: shapes and dtypes, no storage) and
the matching partition specs (:mod:`.sharding`) for the mesh description.

Input shapes (assigned):
    train_4k      seq=4096    global_batch=256   -> train step (MARINA-P round)
    prefill_32k   seq=32768   global_batch=32    -> prefill (forward)
    decode_32k    seq=32768   global_batch=128   -> serve step (1 token + cache)
    long_500k     seq=524288  global_batch=1     -> serve step; sub-quadratic
                  natively (rwkv6, gemma3) or via the sliding-window variant
                  (window = cfg.long_context_window) for full-attention archs.

The port's train state holds flat vectors in ravel order (``server`` [d],
the AdamW moments [d], the ``workers`` [W, d]); its specs are given as the
trees those vectors concatenate, leaf by leaf, as the reference's state
holds them. The train step's randomness is an argument
(``train/downlink.DownlinkDraws``): the abstract draws are a compressed
round's (no sync coin), the branch every count and measurement takes.

The train shape builds one rank's step of ``train/sharded.py`` for the mesh
(``meta["split"] = "per_rank"``): rank 0's state, the global batch, and a
:class:`~repro_torch.launch.comm.CountingComm` that charges the step's
collectives (the layers' forward, backward and recomputed ones included)
and calls no process group. By default it is the reference's default
program, the ``worker`` layout as tensor parallelism over "model" (rank 0's
blocks of every leaf: its replicas' rows of them, the ZeRO-1 slices of its
model-local master over "data") for every family on a ("data", "model")
mesh, on the multi-pod mesh over the flattened ("pod", "data") axes, and on
the hierarchical mesh with the workers on "wk" and each replica and its rows
split over "data" too (``train/sharded.fsdp_blocks``); where a family or a
mesh is not ported the step is split evenly (:func:`train_refusal` names
why). ``train_act_model_sharded=True`` (the
reference's ``act_spec = P("model", None, None)`` where a worker's batch
splits over "model") builds the ``act_spec`` step instead: whole replicas,
each worker's rows split over "model"; where the reference would drop
``act_spec`` (the batch does not split over "model") it runs the tensor
parallel program, the default build, so that request raises. Configs with
experts route each row block at the worker's whole capacity
(``models/moe.split_rows``).

The serving shapes (prefill_32k, decode_32k, long_500k) of every family
(dense, vlm, audio, moe, ssm, hybrid) build rank 0's step of ``serve/sharded.py`` under
``serve_layout`` instead (``meta["split"] = "per_rank"``): its
``shard_params`` blocks, its caches (``shard_caches``), the global batch (the
step takes its rows) and a ``CountingComm`` that charges the ZeRO-3 gathers
over "data", the partial sums over "model" (the routed experts' K·N·D
outputs, Mamba2's gathered ``in_proj`` product and RWKV-6's gathered gates
among them) and the rest of the step's collectives, the all-gathers over
the data axes of the caches that ``cache_specs`` splits on another dim than
the batch or the sequence included (the recurrent states, token shifts and
conv windows of rwkv6 and zamba2 at long_500k's B = 1:
``serve/sharded.make_decode_step``). Every config runs so on every mesh of
``train/sharded.MESHES``; ``meta["even_note"]`` would name what is not ported
where :func:`serving_refusal` or :func:`train_refusal` refuses a step, which
the dry-run then splits evenly (``"even"``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from .. import configs
from ..data import batch_specs as data_batch_specs
from ..models import lm
from ..models.config import ModelConfig
from ..models.params import Leaf, leaf_sizes, map_tree, stacked
from ..optim import make_optimizer
from ..optim.schedules import cosine_warmup
from ..serve import sharded as SS
from ..train import TrainerConfig, init_state, make_downlink, make_train_step
from ..train import sharded as SH
from ..train.downlink import DownlinkDraws, MarinaPDownlink
from . import sharding as sh
from .comm import CountingComm
from .mesh import n_workers as mesh_n_workers

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq=524288, global_batch=1),
}

META = torch.device("meta")


def long_ctx_window(cfg: ModelConfig) -> Optional[int]:
    """Sliding-window override for 500k decode (DESIGN.md §4)."""
    if not cfg.subquadratic:
        return cfg.long_context_window  # dense/moe/vlm/audio: swa variant
    if cfg.family == "hybrid":
        return cfg.long_context_window  # zamba2: window its shared attn slots
    return None  # rwkv6 / gemma3: native


@dataclasses.dataclass
class Built:
    fn: Any
    args: Tuple[Any, ...]
    specs: Tuple[Any, ...]
    meta: dict


def empty(shape, dtype, device=META) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def compressed_draws(downlink, sizes, device=META) -> DownlinkDraws:
    """A compressed round's draws (no sync) of the shapes ``draw_round``
    gives, unfilled: the perm rotations or the Bernoulli masks."""
    if not isinstance(downlink, MarinaPDownlink):
        return DownlinkDraws()
    if downlink.mode == "perm":
        return DownlinkDraws(rot=empty((len(sizes),), torch.int32, device))
    n = downlink.n_workers
    return DownlinkDraws(masks=[empty((n, s) if downlink.mode == "ind" else (s,), torch.bool, device)
                                for s in sizes])


def serve_batch(cfg: ModelConfig, B: int, S: int, device=META) -> dict:
    """A prefill batch of B sequences of S positions (the vlm's patches
    among them)."""
    if cfg.num_codebooks:
        return {"tokens": empty((B, cfg.num_codebooks, S), torch.int32, device)}
    if cfg.num_patches:
        return {"tokens": empty((B, S - cfg.num_patches), torch.int32, device),
                "patches": empty((B, cfg.num_patches, cfg.d_model), torch.bfloat16, device)}
    return {"tokens": empty((B, S), torch.int32, device)}


def decode_token(cfg: ModelConfig, B: int, device=META) -> torch.Tensor:
    return empty((B, cfg.num_codebooks, 1) if cfg.num_codebooks else (B, 1), torch.int32, device)


def train_parts(cfg: ModelConfig, W: int, *, downlink_spec: str = "marina:perm", remat: bool = True,
                attn_chunk: int = 512, remat_policy=None):
    """(step, downlink, TrainerConfig) of the train step the dry-run counts:
    ``downlink_spec`` over W workers, AdamW, cosine_warmup(3e-4, 200,
    20000), bf16 replicas."""
    tcfg = TrainerConfig(n_workers=W, remat=remat, attn_chunk=attn_chunk,
                         weight_dtype=torch.bfloat16, remat_policy=remat_policy)
    downlink = make_downlink(downlink_spec, W)
    optimizer = make_optimizer("adamw")
    step = make_train_step(cfg, tcfg, downlink, optimizer, train_lr())
    return step, downlink, tcfg, optimizer


def train_lr():
    """The counted train step's schedule (the reference's)."""
    return cosine_warmup(3e-4, 200, 20000)


def build(arch_id: str, shape_id: str, mesh, *, downlink_spec: str = "marina:perm",
          remat: bool = True, attn_chunk: int = 512, serve_layout: str = "serve",
          remat_policy=None, train_act_model_sharded: bool = False) -> Built:
    cfg = configs.get(arch_id)
    info = SHAPES[shape_id]
    W = mesh_n_workers(mesh)

    if info["kind"] == "train":
        if info["global_batch"] % W:
            raise ValueError(f"global batch {info['global_batch']} does not split over {W} workers")
        bpw = info["global_batch"] // W
        step, downlink, tcfg, optimizer = train_parts(
            cfg, W, downlink_spec=downlink_spec, remat=remat, attn_chunk=attn_chunk,
            remat_policy=remat_policy)
        state = init_state(cfg, tcfg, downlink, optimizer, device=META)
        meta = dict(cfg=cfg, W=W, bpw=bpw, split="even", **info)
        d = sum(leaf_sizes(lm.lm_spec(cfg)))
        if train_act_model_sharded:
            if "wk" in mesh.axis_names:
                raise ValueError("act_spec on the hierarchical mesh is not ported: its workers' rows split over "
                                 "'data' there (the count without --train-act-model-sharded)")
            if bpw % mesh.shape["model"]:
                raise ValueError(f"{bpw} rows a worker do not split over 'model' = {mesh.shape['model']}: "
                                 "the reference drops act_spec there and runs tensor parallelism over "
                                 "'model' (the count without --train-act-model-sharded)")
            tcfg = dataclasses.replace(tcfg, act_spec=SH.ACT_SPEC)
            layout = SH.make_layout(mesh, 0, W, d)
        else:
            refusal = train_refusal(cfg, mesh)
            layout = None
            if refusal is None:
                layout = SH.make_layout(mesh, 0, W, d, cfg)
            else:
                meta["even_note"] = refusal
        if layout is not None:
            comm = CountingComm()
            step = SH.make_sharded_train_step(cfg, tcfg, downlink, optimizer, train_lr(), layout, comm)
            state = SH.shard_state(state, layout)
            meta.update(split="per_rank", act_spec=tcfg.act_spec, layout=layout, comm=comm)
        batch = {k: empty(s.shape, s.dtype) for k, s in data_batch_specs(cfg, W, bpw, info["seq"]).items()}
        tree = lm.lm_spec(cfg)
        draws = compressed_draws(downlink, leaf_sizes(tree))
        server = sh.param_specs(tree, mesh, "server")
        state_specs = {
            "server": server,
            "opt": sh.param_specs({k: tree if isinstance(v, torch.Tensor) else Leaf(())
                                   for k, v in state["opt"].items()}, mesh, "server"),
            "step": sh.Spec(),
            "bits_per_worker": sh.Spec(),
            "uplink_bits_per_worker": sh.Spec(),
        }
        if "workers" in state:  # MARINA-P's replicas [W, d]; EF21-P's one shift [d]
            wtree = map_tree(lambda leaf: stacked(leaf, W), tree) if state["workers"].dim() == 2 else tree
            state_specs["workers"] = sh.param_specs(wtree, mesh, "worker")
        specs = (state_specs, sh.train_batch_spec(batch, mesh), sh.Spec())
        return Built(step, (state, batch, draws), specs, meta)

    params = lm.lm_init(cfg, device=META)
    p_specs = sh.param_specs(lm.lm_spec(cfg), mesh, serve_layout)
    B, S = info["global_batch"], info["seq"]
    window = long_ctx_window(cfg) if shape_id == "long_500k" else None
    meta = dict(cfg=cfg, window=window, split="even", **info)
    refusal = serving_refusal(cfg, mesh, B, S, window, info["kind"])
    if refusal is None:  # rank 0 of the sharded serving step
        meta.update(split="per_rank", layout=SS.ServeLayout(mesh, 0, serve_layout), comm=CountingComm())
        params = SS.shard_params(params, meta["layout"])
    else:
        meta["even_note"] = refusal
    if info["kind"] == "prefill":
        if meta["split"] == "per_rank":
            prefill_step = SS.make_prefill_step(cfg, meta["layout"], meta["comm"], chunk=attn_chunk)
        else:
            def prefill_step(params, batch):
                with torch.no_grad():
                    return lm.forward(cfg, params, batch, chunk=attn_chunk, remat=remat)

        batch = serve_batch(cfg, B, S)
        return Built(prefill_step, (params, batch), (p_specs, sh.serve_batch_spec(batch, mesh, B)), meta)

    # ---- decode ---------------------------------------------------------------
    caches = lm.cache_init(cfg, B, S, window_override=window, device=META)
    token = decode_token(cfg, B)
    specs = (p_specs, sh.cache_specs(caches, mesh, B), sh.serve_batch_spec(token, mesh, B), sh.Spec())
    if meta["split"] == "per_rank":
        serve_step = SS.make_decode_step(cfg, meta["layout"], meta["comm"], B, S, window_override=window)
        meta["caches"] = caches  # the whole model's: the per-device bytes under cache_specs
        caches = SS.shard_caches(caches, cfg, meta["layout"])
    else:
        def serve_step(params, caches, token, pos):
            with torch.no_grad():
                return lm.decode_step(cfg, params, caches, token, pos, window_override=window)

    return Built(serve_step, (params, caches, token, empty((), torch.int32)), specs, meta)


def train_refusal(cfg: ModelConfig, mesh) -> Optional[str]:
    """None where the dry-run counts one rank of the sharded train step with
    tensor parallelism over "model" for ``cfg`` on ``mesh`` (a ("data",
    "model"), multi-pod ("pod", "data", "model") or hierarchical ("wk",
    "data", "model") mesh: every config, a weight that "model" does not
    split read whole), else what is not ported (the mesh's names, or
    ``train/sharded.check_tensor_parallel``'s message for a family it
    refuses)."""
    if tuple(mesh.axis_names) not in SH.MESHES:
        return f"the train step across a process group runs on a {SH.MESHES} mesh, not {tuple(mesh.axis_names)}"
    if mesh.shape["model"] == 1:
        return None
    layout = SH.make_layout(mesh, 0, mesh_n_workers(mesh), sum(leaf_sizes(lm.lm_spec(cfg))), cfg)
    try:
        SH.check_tensor_parallel(cfg, layout)
    except SS.NotPorted as e:
        return str(e)
    return None


def serving_refusal(cfg: ModelConfig, mesh, batch: int, seq: int, window, kind: str) -> Optional[str]:
    """None where the dry-run counts one rank of the sharded serving step
    (``serve/sharded.py``) for ``cfg`` on ``mesh`` (the ported families on a
    (data axes, "model") mesh, with every cache split ``cache_specs`` makes:
    ``serve/sharded.cache_split``), else what is not ported (the message of
    :class:`~repro_torch.serve.sharded.NotPorted`)."""
    try:
        SS.check_ported(cfg)
        layout = SS.ServeLayout(mesh, 0)
        if kind == "decode":
            SS.cache_layout(cfg, layout, batch, seq, window_override=window)
    except SS.NotPorted as e:
        return str(e)
    return None

"""Batched decode engine over ``lm.decode_step`` (port of
``repro/serve/engine.py``).

Prefill runs decode_step over the prompt one position at a time (filling
the caches), generation samples and steps. The engine serves fixed-batch
request groups (no continuous batching: requests share a prompt length).

The reference jits its prefill and generate scans. On the card the port
captures one decode step in a CUDA graph instead (:class:`_GraphStep`): the
step's small kernels (about 90 a layer) replay with one launch from the
host, against static token, position and cache buffers. The graph reads the
parameters where they live, and ``delta_sync`` updates them in place, so the
next replay serves the update. On the CPU the step runs eagerly.

The serving side of the compressed model broadcast lives here too:
:func:`apply_wire_delta` / :func:`apply_wire_sync` decode a wire message
where the parameters live (``kernels.encode.decode_device``: on the card
every stream goes through the ``unpack_bits`` kernel), validate it, and
only then update the fp32 masters and their bf16 copy.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import wire  # before transport: the transport package imports wire.spec, and wire
from .. import transport  # (through core) imports transport: wire first completes the cycle
from ..kernels.runtime import resolve_device
from ..models import lm
from ..models.config import ModelConfig
from ..models.layers import set_reference_precision
from ..models.params import FlatParams, leaves


def _decode_checked(buf: bytes, d: int, device, what: str) -> torch.Tensor:
    """The message's fp32 [d] vector, decoded to scratch on ``device`` and
    checked: SEED refused, the dimension matched, every value finite."""
    from ..kernels.encode import decode_device

    codec, n = wire.peek(buf)
    if codec == wire.CodecID.SEED:
        raise ValueError(
            "SEED wire messages carry no payload; serving replicas need a "
            "payload codec (SPARSE/NATURAL/DENSE)" if what == "delta" else
            "SEED wire messages cannot carry a full model")
    if n != d:
        raise ValueError(f"wire message dimension {n} != param count {d}")
    vec = decode_device(buf, device)
    if not bool(torch.isfinite(vec).all()):
        raise wire.CorruptFrame(f"wire {what} carries non-finite values")
    return vec


def apply_wire_delta(params: FlatParams, buf: bytes) -> FlatParams:
    """Add a decoded wire downlink message (SPARSE / NATURAL / DENSE over the
    raveled parameters) to ``params`` in place: one fp32 add ``flat + delta``
    into its masters, its bf16 copy refreshed. The delta is decoded to
    scratch and checked first (SEED refused, dimension, finiteness), so a
    bad message leaves the parameters untouched. (A tree of tensors is
    wrapped in a ``FlatParams`` first, as ``DecodeEngine`` does.)"""
    params.flat.data.add_(_decode_checked(buf, params.size, params.device, "delta"))
    return params.refresh()


def apply_wire_sync(params: FlatParams, buf: bytes) -> FlatParams:
    """Replace the parameters with a full-model wire message (a transport
    SYNC payload: the whole raveled model, not a difference), with the
    validate-before-mutate discipline of :func:`apply_wire_delta`."""
    return params.load_flat(_decode_checked(buf, params.size, params.device, "sync"))


def greedy_sample(generator, logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1) (the
    reference draws ``jax.random.gumbel``; tests inject its draws here)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def temperature_sample(temp: float = 1.0):
    """Sampling at temperature ``temp``: argmax(logits / temp + Gumbel
    noise), the Gumbel-max form of the reference's
    ``jax.random.categorical``, drawn from the engine's generator."""

    def fn(generator, logits):
        noise = gumbel(generator, logits.shape, logits.device)
        return torch.argmax(noise + logits.to(torch.float32) / temp, dim=-1).to(torch.int32)

    return fn


class _GraphStep:
    """One decode step captured in a CUDA graph: ``logits = step(tok, pos)``
    against static token / position / cache buffers, the new caches copied
    into the static ones inside the graph. ``logits`` is a static buffer,
    overwritten by the next replay."""

    def __init__(self, engine: "DecodeEngine"):
        cfg, dev = engine.cfg, engine.device
        shape = (engine.batch_size, cfg.num_codebooks, 1) if cfg.num_codebooks else (engine.batch_size, 1)
        self.tok = torch.zeros(shape, dtype=torch.int64, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.caches = engine.fresh_caches()
        static = leaves(self.caches)

        def step():
            logits, new = lm.decode_step(cfg, engine.params, self.caches, self.tok, self.pos,
                                         window_override=engine.window_override)
            for s, n in zip(static, leaves(new)):
                s.copy_(n)
            return logits

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):  # warm-up outside the capture
            step()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits = step()

    def reset(self) -> None:
        for t in leaves(self.caches):
            t.zero_()

    def __call__(self, tok: torch.Tensor, pos: int) -> torch.Tensor:
        self.tok.copy_(tok)
        self.pos.fill_(pos)
        self.graph.replay()
        return self.logits


@dataclasses.dataclass
class DecodeEngine:
    cfg: ModelConfig
    params: object  # a FlatParams (lm.lm_init / convert.lm_params_from_numpy); a tree is copied into one
    cache_len: int
    batch_size: int
    window_override: Optional[int] = None
    sample_fn: Callable = greedy_sample
    tracker: Optional[object] = None  # repro_torch.obs.Tracker: request latency telemetry
    device: str = "cuda"

    _delta_seq: Optional[int] = dataclasses.field(default=None, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if not isinstance(self.params, FlatParams):
            from ..convert import ravel_params

            self.params = FlatParams(self.params, self.device).load_flat(ravel_params(self.params))
        elif self.params.device != self.device:
            self.params = self.params.clone_to(self.device)
        if self.device.type == "cuda":
            set_reference_precision()
        self._graph: Optional[_GraphStep] = None

    def fresh_caches(self):
        return lm.cache_init(self.cfg, self.batch_size, self.cache_len,
                             window_override=self.window_override, device=self.device)

    # -- the step -------------------------------------------------------------

    def _stepper(self):
        """``step(tok, pos) -> logits`` for one request: the captured graph
        with its caches zeroed, or an eager step over fresh caches."""
        if self.device.type == "cuda":
            if self._graph is None:
                self._graph = _GraphStep(self)
            self._graph.reset()
            return self._graph
        state = {"caches": self.fresh_caches()}

        def step(tok, pos):
            logits, state["caches"] = lm.decode_step(self.cfg, self.params, state["caches"], tok, pos,
                                                     window_override=self.window_override)
            return logits

        return step

    def prefill(self, step, prompts: torch.Tensor, keep_last: int = 1):
        """Run the prompt [B, S] (or [B, K, S]) through ``step`` one position
        at a time (the reference's per-position decode scan); returns the
        logits of the last ``keep_last`` positions, stacked on axis 1 if
        ``keep_last > 1`` (copies: the graph's buffer is reused)."""
        S = prompts.shape[-1]
        kept = []
        for i in range(S):
            logits = step(prompts[..., i:i + 1], i)
            if i >= S - keep_last:
                kept.append(logits.clone())
        return kept[-1] if keep_last == 1 else torch.stack(kept, 1)

    def generate(self, step, last_logits: torch.Tensor, start_pos: int, n_steps: int,
                 generator: torch.Generator) -> torch.Tensor:
        """Sample a token from the logits, decode it, ``n_steps`` times (the
        reference's generate scan). Returns tokens [B, n] (or [B, K, n])."""
        cfg = self.cfg
        logits, toks = last_logits, []
        for i in range(n_steps):
            tok = self.sample_fn(generator, logits)
            tok = tok.reshape(tok.shape[0], cfg.num_codebooks, 1) if cfg.num_codebooks \
                else tok.reshape(tok.shape[0], 1)
            logits = step(tok, start_pos + i)
            toks.append(tok[..., 0])
        return torch.stack(toks, -1)

    # -- the model-update downlink ---------------------------------------------

    def delta_sync(self, buf: bytes) -> None:
        """Apply a wire delta message to the served parameters in place.

        ``buf`` is a bare wire message or a transport frame. Framed deltas
        are sequence-gated: a DATA frame at or below the last applied
        sequence raises ``StaleDelta`` (deltas are not idempotent), one that
        skips ahead raises ``SequenceGap`` (the replica needs a resync). A
        SYNC frame carries the full model (:func:`apply_wire_sync` replaces
        rather than adds), is accepted at any forward sequence and resets
        the gate. The parameters change only after the payload validates."""
        from ..obs.trace import maybe_attr, maybe_span

        with maybe_span(self.tracker, "serve/delta_sync", bytes=len(buf)) as sp:
            self._delta_sync(bytes(buf), sp, maybe_attr)

    def _delta_sync(self, buf: bytes, sp, maybe_attr) -> None:
        if transport.is_frame(buf):
            frame, _ = transport.decode_frame(buf)
            if frame.ftype == transport.FrameType.SYNC:
                if self._delta_seq is not None and frame.seq <= self._delta_seq:
                    raise transport.StaleDelta(
                        f"sync seq {frame.seq} <= last applied {self._delta_seq}")
                self.params = apply_wire_sync(self.params, frame.payload)
                self._delta_seq = frame.seq
                maybe_attr(sp, ftype="SYNC", seq=frame.seq)
                return
            if frame.ftype == transport.FrameType.DATA:
                if self._delta_seq is not None:
                    if frame.seq <= self._delta_seq:
                        raise transport.StaleDelta(
                            f"delta seq {frame.seq} <= last applied {self._delta_seq}")
                    if frame.seq != self._delta_seq + 1:
                        raise transport.SequenceGap(
                            f"delta seq {frame.seq} skips past {self._delta_seq + 1}; resync required")
            else:
                raise ValueError(f"frame type {frame.ftype!r} carries no delta")
            self.params = apply_wire_delta(self.params, frame.payload)
            self._delta_seq = frame.seq
            maybe_attr(sp, ftype="DATA", seq=frame.seq)
        else:
            self.params = apply_wire_delta(self.params, buf)
            maybe_attr(sp, ftype="bare")

    # -- a request --------------------------------------------------------------

    def run(self, prompts, n_new_tokens: int, seed: int = 0):
        """prompts: [B, S] (or [B, K, S]). Returns generated tokens [B, n]
        (int32, on the engine's device).

        With a ``tracker``, each request logs its prefill / decode latency
        ("serve/prefill", "serve/decode" timer events) and a tokens/s metric,
        inside a "serve/request" span with "prefill" / "decode" children."""
        from .. import obs
        from ..obs.trace import maybe_attr, span

        tracker = self.tracker or obs.NullTracker()
        if not isinstance(prompts, torch.Tensor):
            prompts = torch.as_tensor(np.asarray(prompts))
        prompts = prompts.to(device=self.device, dtype=torch.int64)
        generator = torch.Generator(self.device).manual_seed(seed)
        step = self._stepper()
        with span(tracker, "serve/request", batch=prompts.shape[0], prompt_len=prompts.shape[-1],
                  new_tokens=n_new_tokens) as rsp:
            with span(tracker, "prefill"):
                with tracker.time_block("serve/prefill") as tb:
                    last_logits = self.prefill(step, prompts)
                    tb.block(last_logits)
                prefill_s = tb.seconds
            with span(tracker, "decode"):
                with tracker.time_block("serve/decode") as tb:
                    toks = self.generate(step, last_logits, prompts.shape[-1], n_new_tokens, generator)
                    tb.block(toks)
                decode_s = tb.seconds
            tokens_per_s = prompts.shape[0] * n_new_tokens / decode_s if decode_s > 0 else 0.0
            maybe_attr(rsp, tokens_per_s=tokens_per_s)
        tracker.log({
            "serve/request_s": prefill_s + decode_s,
            "serve/tokens_per_s": tokens_per_s,
            "serve/batch": prompts.shape[0],
            "serve/prompt_len": prompts.shape[-1],
            "serve/new_tokens": n_new_tokens,
        })
        return toks

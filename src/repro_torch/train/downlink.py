"""MARINA-P / EF21-P as the model-broadcast layer of LM training (port of
``repro/train/downlink.py``).

After the server's optimizer step, the *model delta* broadcast to each
data-parallel worker replica is compressed:

* :class:`MarinaPDownlink` — Algorithm 2 over the model. Worker replicas are
  one [W, d] tensor in ravel order (the reference's leading ``W`` axis), in
  fp32 or the trainer's ``weight_dtype``; broadcast modes:
    - ``perm``: RotK cyclic-partition PermK (omega = W-1, exact-mean
      identity), through the ``rotk_apply_rows`` kernel: one launch a leaf
      updates the W replicas, reading the leaf's delta once and writing
      straight into the new [W, d] (no per-worker loop, no copy);
    - ``ind`` : per-worker Bernoulli-K (omega = d/k - 1);
    - ``same``: one Bernoulli-K mask shared by the workers.
  With probability ``p`` the full model is synchronized (Bernoulli coin).
* :class:`EF21PDownlink` — Algorithm 1 with block-TopK (the ``block_topk``
  kernel) per leaf. The synchronized shift is one [d] vector (all workers
  identical).

The model is a flat [d] vector in ravel order; ``sizes`` (``params.leaf_sizes``
of the model's spec) cuts it into the reference's leaves, which matter: the
RotK coordinate index and the top-k blocks restart in every leaf.
``MarinaPDownlink.round_rows`` updates replicas ``off ...`` of the W only
(one rank's rows in ``train/sharded.py``).

A round's randomness is drawn once, by :func:`draw_round` (tests monkeypatch
it to inject the reference's draws): the sync coin on the host, so the round
branches without a device sync and computes only its own branch, and the
rotations or Bernoulli masks on the device's generator. ``round``,
``measure_wire`` and ``broadcast_via`` consume the same :class:`DownlinkDraws`
(the reference replays them from its key).

Both track the paper's analytic WAN bits per round (comm_model) as float32.
``measure_wire`` / ``broadcast_via`` serialize the real messages: on a card
through the encode kernels (``dense_encode`` / ``encode_rows`` /
``sparse_encode``), on the CPU through the host codec.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import wire  # before kernels.encode and transport (import order)
from ..core.comm_model import CommModel
from ..core.compressors import BlockTopK
from ..kernels import encode as kenc
from ..kernels import ops
from ..models.params import leaf_sizes
from ..obs.trace import maybe_attr, maybe_span

F32 = np.float32


class DownlinkDraws(NamedTuple):
    """One round's randomness (all of it; the round and the wire share it)."""

    coin: bool = False  # c^t: full sync this round (drawn on the host)
    rot: Optional[torch.Tensor] = None  # perm: int32 [L] rotations on the device, one per leaf
    masks: Optional[List[torch.Tensor]] = None  # ind: bool [W, size] per leaf; same: bool [size]
    seed: int = 0  # the SEED message's seed field (what seed-only transport would send)
    part: object = None  # the participation plan's draws (the trainer's; plan.draw)


def tree_size(tree) -> int:
    """Number of parameters of a tree of tensors or ``Leaf`` specs."""
    return sum(leaf_sizes(tree))


def _segments(sizes: Sequence[int]):
    """(leaf index, offset, size) of each leaf in the flat vector."""
    o = 0
    for li, s in enumerate(sizes):
        yield li, o, s
        o += s


class LeafBlock(NamedTuple):
    """One rank's block of a leaf split over a mesh axis, in the rank's flat
    vector of blocks: at ``lo``, ``size`` values, block element t being leaf
    coordinate ``offset + (t // chunk) * stride + t % chunk`` (a leaf the
    axis does not split: chunk = stride = its size, offset 0)."""

    lo: int
    size: int
    chunk: int
    stride: int
    offset: int

    @property
    def map(self) -> tuple:
        return self.chunk, self.stride, self.offset

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        """The block's values of ``t`` [..., leaf size], as [..., size]."""
        lead = t.shape[:-1]
        return t.reshape(*lead, -1, self.stride)[..., self.offset:self.offset + self.chunk].reshape(*lead, -1)


def _dense_buf(flat: torch.Tensor, mag, device_encode) -> bytes:
    """The full model (fp32) serialized for a sync broadcast."""
    flat = flat.float().contiguous()
    if kenc.device_encode_enabled(device_encode, flat):
        return kenc.dense_encode(flat, mag=mag)
    return wire.encode_dense(flat.cpu().numpy(), mag=mag)


def _track_wire(tracker, step, res: dict) -> dict:
    """Log a measure_wire result as downlink/* metrics; returns ``res``."""
    if tracker is not None:
        tracker.log(
            {
                "downlink/wire_bits_mean": res["bits_mean"],
                "downlink/wire_bits_analytic": res["bits_analytic"],
                "downlink/full_sync": res["full_sync"],
                **({"downlink/wire_bits_seed": res["bits_seed"]} if "bits_seed" in res else {}),
            },
            step=step,
        )
    return res


def _deliver(fleet, payloads, sync: bool, tracker, step, bsp) -> dict:
    """Send ``payloads`` (one: a broadcast; else one per worker), drain, and
    report delivery as ``broadcast_via`` returns it."""
    oks = (fleet.broadcast(payloads[0], sync=sync) if len(payloads) == 1
           else fleet.send_per_worker(payloads))
    fleet.drain()
    res = {"full_sync": sync, "oks": oks, "delivered_frac": sum(oks) / len(oks),
           "resync_needed": fleet.resync_needed or not all(oks)}
    maybe_attr(bsp, delivered=int(sum(oks)), resync_next=res["resync_needed"])
    return res


def _log_delivery(fleet, tracker, step, res) -> dict:
    if tracker is not None:
        tracker.log({"downlink/full_sync": res["full_sync"],
                     "downlink/delivered_frac": res["delivered_frac"]}, step=step)
        fleet.log_to(tracker, step=step)
    return res


@dataclasses.dataclass(frozen=True)
class MarinaPDownlink:
    """Compressed server->worker model broadcast (Algorithm 2)."""

    n_workers: int
    mode: str = "perm"          # perm | ind | same
    keep_frac: float = 0.0      # bern modes: k/d; default 1/n (PermK-parity)
    p: float = 0.0              # full-sync probability; default 1/n

    @property
    def sync_p(self) -> float:
        return self.p if self.p > 0 else 1.0 / self.n_workers

    @property
    def frac(self) -> float:
        if self.mode == "perm":
            return 1.0 / self.n_workers
        return self.keep_frac if self.keep_frac > 0 else 1.0 / self.n_workers

    def omega(self) -> float:
        if self.mode == "perm":
            return self.n_workers - 1.0
        return 1.0 / self.frac - 1.0

    def init_workers(self, server: torch.Tensor) -> torch.Tensor:
        """w_i^0 = x^0 for all i: [W, d]."""
        return server.expand(self.n_workers, server.shape[0]).clone()

    def round(self, draws: DownlinkDraws, sizes, server_new, server_old, workers, force_sync=False):
        """One downlink round -> (new workers [W, d], bits/worker this round).

        Only the drawn branch runs (the reference's ``lax.cond``): a full
        sync casts x^{t+1} into every replica; otherwise replica i adds
        Q_i(x^{t+1} - x^t) in its own dtype. ``force_sync`` promotes the round
        to the full broadcast, the transport layer's resync path."""
        return self._round(draws, sizes, server_new, lambda o, s: server_new[o:o + s] - server_old[o:o + s],
                           workers, 0, force_sync)

    def round_rows(self, draws: DownlinkDraws, sizes, server_new, delta, workers, off: int,
                   force_sync=False, blocks: Optional[Sequence[LeafBlock]] = None):
        """:meth:`round` for replicas ``off ... off + R - 1`` of the W
        (``workers``: [R, d], one rank's rows of the sharded train step),
        from the round's fp32 delta x^{t+1} - x^t [d] (None in a sync
        round). Row i is worker ``off + i``: perm passes the rotation
        ``(r + off) mod W`` to ``rotk_apply_rows``, ind takes mask rows
        ``off ... off + R - 1``; the values equal rows ``off ...`` of
        :meth:`round`'s bit for bit. ``blocks`` (one :class:`LeafBlock` a
        leaf of ``sizes``): the rows, ``server_new`` and ``delta`` hold only
        the rank's blocks of the leaves [d_local] (tensor parallelism over
        "model"); perm's kept rule reads each block column's leaf coordinate
        (``rotk_apply_rows``' block map), ind / same cut the leaf's mask to
        the block, and the values equal those columns of :meth:`round`'s."""
        return self._round(draws, sizes, server_new, lambda o, s: delta[o:o + s], workers, off, force_sync,
                           blocks)

    def _round(self, draws, sizes, server_new, leaf_delta, workers, off, force_sync, blocks=None):
        n = self.n_workers
        sync = draws.coin or force_sync
        if sync:
            new = server_new.to(workers.dtype).expand_as(workers).clone()
        else:
            R = workers.shape[0]
            new = torch.empty_like(workers)
            # XLA rewrites the jitted reference's delta / frac as a float32 product
            # with the float32 reciprocal of frac in the replicas' dtype
            scale = float(1 / torch.tensor(self.frac, dtype=workers.dtype).float())
            # row i is worker off + i: rotate by off on the device, once a round
            rot = (None if self.mode != "perm" else draws.rot if off == 0
                   else torch.remainder(draws.rot + off, n).to(torch.int32))
            for li, o, s in _segments(sizes):
                blk = None if blocks is None else blocks[li]
                if blk is not None:
                    o, s = blk.lo, blk.size
                delta = leaf_delta(o, s).to(workers.dtype)
                if self.mode == "perm":  # all R replicas of the leaf in one launch
                    ops.rotk_apply_rows(workers[:, o:o + s], delta, rot[li:li + 1], n=n,
                                        out=new[:, o:o + s], block=None if blk is None else blk.map)
                else:
                    mask = draws.masks[li] if self.mode == "same" else draws.masks[li][off:off + R]
                    if blk is not None:
                        mask = blk.cut(mask)
                    q = torch.where(mask, delta * scale, 0)
                    torch.add(workers[:, o:o + s], q, out=new[:, o:o + s])
        d = sum(sizes)  # the whole model's, with blocks too
        cm = CommModel(d=d)  # single source of truth for the bit formulas
        return new, F32(cm.dense_bits() if sync else cm.sparse_bits(self.frac * d))

    def drift_sum(self, server, workers) -> torch.Tensor:
        """sum_i ||w_i - x||^2 over the rows of ``workers``."""
        return ((workers.float() - server.float()) ** 2).sum()

    def worker_drift(self, server, workers) -> torch.Tensor:
        """mean_i ||w_i - x||^2, the Lyapunov drift term of Theorem 2."""
        return self.drift_sum(server, workers) / self.n_workers

    def messages(self, draws, sizes, server_new, server_old) -> torch.Tensor:
        """The compressed deltas [W, d] fp32 (one row in 'same' mode, where
        every worker's message is identical) of the round ``draws`` made: the
        reference's host-side replay, op by op (a true division by frac)."""
        n = self.n_workers
        Q = torch.zeros((1 if self.mode == "same" else n, sum(sizes)), dtype=torch.float32,
                        device=server_new.device)
        for li, o, s in _segments(sizes):
            delta = (server_new[o:o + s] - server_old[o:o + s]).float()
            if self.mode == "perm":
                # Q_i(delta) is rotk_apply on a zero replica (one row broadcast to
                # the W rows): n * delta where kept (0 + x = x exactly), +0.0
                # elsewhere, which SPARSE drops as it drops the reference's -0.0
                ops.rotk_apply_rows(torch.zeros_like(delta).expand(n, s), delta, draws.rot[li:li + 1],
                                    n=n, out=Q[:, o:o + s])
            else:
                q = delta / delta.new_full((), self.frac)
                Q[:, o:o + s] = torch.where(draws.masks[li], q, 0)
        return Q

    def _sparse_bufs(self, draws, sizes, server_new, server_old, mag, device_encode=None):
        """Per-worker SPARSE buffers of :meth:`messages`; 'same' mode encodes
        once and repeats the buffer; the device path encodes all rows in one
        ``encode_rows``."""
        Q = self.messages(draws, sizes, server_new, server_old)
        if kenc.device_encode_enabled(device_encode, Q):
            bufs = kenc.encode_rows(Q, mag=mag)
        else:
            bufs = [wire.encode_sparse(r, mag=mag) for r in Q.cpu().numpy()]
        return bufs * self.n_workers if self.mode == "same" else bufs

    def measure_wire(self, draws, sizes, server_new, server_old, *, mag="fp32",
                     device_encode=None, tracker=None, step=None) -> dict:
        """Wire measurement of this round (the measure_wire=True path).

        Rebuilds each worker's message from ``draws`` and serializes it with
        the wire codecs (device encode on a card unless ``device_encode`` is
        False). Returns measured bits beside the analytic model's prediction
        (value_bits matched to ``mag``) and the O(1) seed-only alternative
        (DESIGN.md §3.5). ``tracker`` logs the result as ``downlink/*``
        metrics."""
        n = self.n_workers
        d = sum(sizes)
        cm = CommModel(d=d, value_bits=wire.MAG_BITS[wire.mag_dtype(mag)])
        seed_buf = wire.encode_seed(
            wire.SeedMessage(
                family=wire.SeedFamily.ROTK if self.mode == "perm" else wire.SeedFamily.BERN,
                seed=draws.seed, round=0, scale=1.0, n=n, worker=0, param=self.frac),
            d)
        if draws.coin:
            bits = float(wire.measured_bits(_dense_buf(server_new, mag, device_encode)))
            return _track_wire(tracker, step, {
                "full_sync": True, "bits_mean": bits, "bits_per_worker": [bits] * n,
                "bits_seed": float(wire.measured_bits(seed_buf)),
                "bits_analytic": cm.dense_bits()})
        per_worker = [float(wire.measured_bits(buf)) for buf in
                      self._sparse_bufs(draws, sizes, server_new, server_old, mag, device_encode)]
        return _track_wire(tracker, step, {
            "full_sync": False,
            "bits_mean": sum(per_worker) / n,
            "bits_per_worker": per_worker,
            "bits_seed": float(wire.measured_bits(seed_buf)),
            "bits_analytic": cm.sparse_bits(self.frac * d),
        })

    def broadcast_via(self, fleet, draws, sizes, server_new, server_old, *, mag="fp32",
                      device_encode=None, force_sync=False, tracker=None, step=None) -> dict:
        """Push this round's broadcast through a :class:`repro_torch.transport.Fleet`.

        Serializes the messages of the round ``draws`` (and ``force_sync``)
        made and delivers them over the fault-injected links. Sync rounds
        travel as self-contained SYNC frames (they repair any receiver gap).
        Returns per-worker delivery flags plus whether the *next* round must
        be promoted to a full sync (DESIGN.md §8.4)."""
        c = bool(draws.coin or force_sync)
        if tracker is not None:
            fleet.attach_tracker(tracker)
        with maybe_span(tracker, "broadcast", full_sync=c) as bsp:
            with maybe_span(tracker, "encode",
                            device=kenc.device_encode_enabled(device_encode, server_new)):
                if c:
                    payloads = [_dense_buf(server_new, mag, device_encode)]
                else:
                    payloads = self._sparse_bufs(draws, sizes, server_new, server_old, mag,
                                                 device_encode)
            res = _deliver(fleet, payloads, c, tracker, step, bsp)
        return _log_delivery(fleet, tracker, step, res)


@dataclasses.dataclass(frozen=True)
class EF21PDownlink:
    """EF21-P with block-local TopK (Algorithm 1), leaf by leaf."""

    n_workers: int
    k_per_block: int = 128
    block: int = 1024

    @property
    def comp(self) -> BlockTopK:
        return BlockTopK(k_per_block=self.k_per_block, block=self.block)

    def init_shift(self, server: torch.Tensor) -> torch.Tensor:
        """w^0 = x^0; one vector — workers stay synchronized by construction."""
        return server.clone()

    def init_workers(self, server):
        return self.init_shift(server)

    def compressed(self, sizes, server_new, shift) -> torch.Tensor:
        """C(x - w) of each leaf, fp32, concatenated in ravel order: the
        broadcast message."""
        comp = self.comp
        out = torch.empty(sum(sizes), dtype=torch.float32, device=shift.device)
        for _, o, s in _segments(sizes):
            out[o:o + s] = comp(server_new[o:o + s].float() - shift[o:o + s].float())
        return out

    def round(self, draws, sizes, server_new, shift, force_sync=False):
        """-> (new shift [d], bits/worker). ``force_sync`` re-anchors the
        shift with a dense ``w := x`` broadcast, the transport layer's
        resync path (DESIGN.md §8.4); only the branch taken is computed."""
        d = sum(sizes)
        cm = CommModel(d=d)
        if force_sync:
            return server_new.to(shift.dtype).clone(), F32(cm.dense_bits())
        new = shift + self.compressed(sizes, server_new, shift).to(shift.dtype)
        return new, F32(cm.sparse_bits(self.k_per_block / self.block * d))

    def _delta_buf(self, sizes, server_new, shift, mag, device_encode=None) -> bytes:
        """The block-TopK compressed difference over the raveled model (the
        broadcast message, identical for every worker)."""
        delta = self.compressed(sizes, server_new, shift)
        if kenc.device_encode_enabled(device_encode, delta):
            return kenc.sparse_encode(delta, mag=mag)
        return wire.encode_sparse(delta.cpu().numpy(), mag=mag)

    def measure_wire(self, draws, sizes, server_new, shift, *, mag="fp32",
                     device_encode=None, tracker=None, step=None) -> dict:
        """Wire measurement of one EF21-P broadcast (the block-TopK
        compressed difference, identical for every worker)."""
        d = sum(sizes)
        cm = CommModel(d=d, value_bits=wire.MAG_BITS[wire.mag_dtype(mag)])
        bits = float(wire.measured_bits(self._delta_buf(sizes, server_new, shift, mag, device_encode)))
        return _track_wire(tracker, step, {
            "full_sync": False,
            "bits_mean": bits,
            "bits_per_worker": [bits] * self.n_workers,
            "bits_analytic": cm.sparse_bits(self.k_per_block / self.block * d),
        })

    def broadcast_via(self, fleet, draws, sizes, server_new, shift, *, mag="fp32",
                      device_encode=None, force_sync=False, tracker=None, step=None) -> dict:
        """Deliver one EF21-P broadcast through a transport Fleet.

        A sync round ships the full model (``w := x`` re-anchor) as a
        self-contained SYNC frame; otherwise the block-TopK compressed
        difference, identical for every worker. ``resync_needed`` in the
        result means the caller must pass ``force_sync=True`` to the next
        :meth:`round`."""
        sync = bool(force_sync)
        if tracker is not None:
            fleet.attach_tracker(tracker)
        with maybe_span(tracker, "broadcast", full_sync=sync) as bsp:
            with maybe_span(tracker, "encode",
                            device=kenc.device_encode_enabled(device_encode, server_new)):
                buf = (_dense_buf(server_new, mag, device_encode) if sync
                       else self._delta_buf(sizes, server_new, shift, mag, device_encode))
            res = _deliver(fleet, [buf], sync, tracker, step, bsp)
        return _log_delivery(fleet, tracker, step, res)

    def worker_drift(self, server, shift) -> torch.Tensor:
        return ((shift.float() - server.float()) ** 2).sum()


def draw_round(downlink, sizes, generator: torch.Generator,
               device_generator: torch.Generator) -> DownlinkDraws:
    """One round's draws for ``downlink`` over leaves of ``sizes``: the sync
    coin and the SEED field from ``generator`` (a CPU generator: the branch
    is known on the host), then, for a round that is not a sync, the
    mode's rotations or masks on ``device_generator``'s device. EF21-P and
    the exact broadcast (None) draw nothing."""
    if not isinstance(downlink, MarinaPDownlink):
        return DownlinkDraws()
    coin = bool(torch.rand((), generator=generator) < downlink.sync_p)
    seed = int(torch.randint(0, 2**32, (), generator=generator))
    if coin:
        return DownlinkDraws(coin=True, seed=seed)
    n, dev = downlink.n_workers, device_generator.device
    if downlink.mode == "perm":
        rot = torch.randint(0, n, (len(sizes),), generator=device_generator, device=dev,
                            dtype=torch.int32)
        return DownlinkDraws(rot=rot, seed=seed)
    shape = (lambda s: (n, s)) if downlink.mode == "ind" else (lambda s: (s,))
    masks = [torch.rand(shape(s), generator=device_generator, device=dev) < downlink.frac
             for s in sizes]
    return DownlinkDraws(masks=masks, seed=seed)


def make_downlink(spec: str, n_workers: int):
    """``marina:perm``, ``marina:ind:0.0625``, ``marina:same``, ``ef21p:128:1024``,
    ``none`` (exact broadcast baseline)."""
    parts = spec.split(":")
    if parts[0] == "none":
        return None
    if parts[0] == "marina":
        mode = parts[1] if len(parts) > 1 else "perm"
        keep = float(parts[2]) if len(parts) > 2 else 0.0
        return MarinaPDownlink(n_workers=n_workers, mode=mode, keep_frac=keep)
    if parts[0] == "ef21p":
        kb = int(parts[1]) if len(parts) > 1 else 128
        b = int(parts[2]) if len(parts) > 2 else 1024
        return EF21PDownlink(n_workers=n_workers, k_per_block=kb, block=b)
    raise ValueError(spec)

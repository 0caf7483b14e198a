"""Elastic data-parallel training: survive rank loss by reforming
(counterpart of paddle_tpu/resilience/elastic.py).

`ElasticTrainer` runs data parallelism over the process-group store
(distributed/elastic.py): every member computes gradients on its slice of
the global batch, publishes them, and applies the batch-size-weighted
average, so the parameter trajectory is a function of the global batch,
whatever the number of members splitting it. After a rank dies the
survivors reform at N-1 and the loss trajectory continues within
floating-point reassociation noise of the run without the failure.

The loop per global step, the reference's:

    1. chaos check: an armed rank kill stops heartbeating and leaves the
       loop (an unannounced crash, as the survivors see it);
    2. membership poll: adopt or propose a new generation if leases
       expired, someone left, or a joiner announced itself;
    3. shard the global batch by the rebalancer's shares (an equal split
       unless the straggler signal shifted them within the bounded skew),
       forward and backward on this member's shard
       (`TrainStep.forward_backward`, under the amp state the loss
       function sets);
    4. the store exchange: publish the gradients and {shard size, loss,
       wall time}, collect every other member's, and take the weighted
       average in sorted member order, so every member does the same float
       operations and the parameters stay bitwise-replicated;
    5. a collection timeout names the missing members (PeerLostError):
       wait for their leases to expire, adopt the reformed view and
       reform: a new CheckpointManager for the new rank and world, the
       step's caches dropped (`invalidate_executables`), the full state
       restored from the last committed rank-sharded checkpoint (load at
       target_world_size=1), training resumed from its step;
    6. every `save_every` steps a synchronised rank-sharded checkpoint
       (backend "sharded", commit keys namespaced by the generation).

Step 0 always commits a checkpoint, so one exists before any failure can.

How the port runs step 4. The gradients are the optimizer's flat buffer
(AdamW's); they cross to pinned host memory in one copy a buffer, are
packed (`_pack`: one buffer, the reference's wire format) and published.
The average is folded on the device, member by member in sorted order, as
each contribution arrives: its arrays are read out of the received bytes
one at a time, copied to the card, scaled by n_m / n in fp32 and added
(separate multiply and add, each correctly rounded, as numpy's are), then
dropped; so a rank holds one contribution's bytes at a time, not all of
them. The sum runs in the member's own gradient buffer when it is the
first or second member (addition of two terms commutes bitwise), else in a
separate buffer copied in at the end; its own contribution is never
fetched back from the store, and a member alone publishes nothing. The
averaged gradients, in the existing gradient buffers, go through the
optimizer's `step()` (on the card, the fused AdamW kernel); gradient
clipping is not applied on this path, as in the reference. Every step
records its parts (`step_parts`): fwd_bwd, d2h, pack, publish, collect
(waiting for and reading the others' bytes), unpack_average, h2d and
apply, in seconds, with the bytes sent and received.

Buffers (running statistics) stay per member, not averaged, as in the
reference.

Threads as ranks (tests): N threads share one InProcStore, each owning its
own model, optimizer and trainer. The same code runs one process a rank
over native.TCPStore (distributed.spawn).
"""
from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import chaos
from .checkpoint_manager import CheckpointManager, _host_copies
from .trainer import load_train_state, train_state
from ..core.flags import define_flag, get_flag
from ..distributed.checkpoint import split_bounds
from ..distributed.elastic import (ElasticMembership, MembershipView,
                                   PeerLostError, StoreReducer, _pack,
                                   _unpack_iter)
from ..jit.trainer import TrainStep
from ..observability import cluster as _cluster  # noqa: F401 — straggler flags
from ..observability import flight_recorder as _flight
from ..observability.registry import counter as _counter

define_flag("elastic_rebalance_skew", 0.0,
            "Bound on straggler-aware micro-batch rebalancing: a detected "
            "straggler's batch share can shrink to at most (1 - skew) of "
            "its equal share, the slack spread over the others. 0 disables "
            "rebalancing (always equal split).")
define_flag("elastic_eject_patience", 0,
            "Auto-eject chronically slow ranks: when the rebalancer has "
            "pinned a member at the (1 - skew) share clamp for this many "
            "consecutive observation windows, the lowest-id non-straggler "
            "member ejects it from the view and training reforms at N-1 "
            "(membership_ejections_total counts it; the flight recorder "
            "dumps the evidence). 0 (default) disables auto-ejection.")

_REBALANCES = _counter("elastic_rebalance_events_total",
                       "Steps whose batch shares deviated from the equal "
                       "split due to the straggler signal.", always=True)
_REFORM_STEPS = _counter("elastic_reforms_total",
                         "Mesh reformations performed by ElasticTrainer.",
                         always=True)
_EJECTIONS = _counter("membership_ejections_total",
                      "Members auto-ejected by ElasticTrainer for chronic "
                      "straggling pinned past the rebalance clamp.",
                      always=True)

__all__ = ["ElasticTrainer", "MicroBatchRebalancer"]

PARTS = ("fwd_bwd", "d2h", "pack", "publish", "collect", "unpack_average",
         "h2d", "apply")


class MicroBatchRebalancer:
    """Deterministic straggler-aware batch-share policy, short of ejection.

    Fed the per-member wall times every member saw in the same exchange
    records, so every member computes identical shares. A member whose
    wall time exceeds `FLAGS_straggler_k` x the median of the others for
    `FLAGS_straggler_m` consecutive steps gets its share scaled by
    median/ema, floored at (1 - skew) of equal. The weighted gradient
    average keeps the update exact under any split, so rebalancing never
    perturbs the loss trajectory, only who computes how much of it."""

    def __init__(self, *, skew: Optional[float] = None,
                 k: Optional[float] = None, m: Optional[int] = None,
                 ema_alpha: float = 0.5):
        self.skew = float(skew if skew is not None
                          else get_flag("elastic_rebalance_skew"))
        self.k = float(k if k is not None else get_flag("straggler_k"))
        self.m = int(m if m is not None else get_flag("straggler_m"))
        self.ema_alpha = float(ema_alpha)
        self._ema: Dict[int, float] = {}
        self._streak: Dict[int, int] = {}
        self._pinned: Dict[int, int] = {}
        self.weights: Dict[int, float] = {}

    def reset(self) -> None:
        self._ema.clear()
        self._streak.clear()
        self._pinned.clear()
        self.weights.clear()

    def pinned_streak(self, member: int) -> int:
        """Consecutive observation windows this member's weight sat at the
        (1 - skew) clamp (slower than rebalancing can make up for); the
        same on every member, so the auto-eject decision needs no extra
        coordination."""
        return self._pinned.get(member, 0)

    def observe(self, step: int, walls: Dict[int, float]) -> None:
        """Fold one step's per-member wall times into the straggler state.
        Each member is judged against the median of the others; the
        streak counts consecutive slow raw walls, the weight uses the
        smoothed ratio."""
        a = self.ema_alpha
        for m in list(self._ema):
            if m not in walls:  # member reformed away
                self._ema.pop(m, None)
                self._streak.pop(m, None)
                self._pinned.pop(m, None)
                self.weights.pop(m, None)
        for m, w in walls.items():
            prev = self._ema.get(m)
            self._ema[m] = float(w) if prev is None \
                else a * float(w) + (1 - a) * prev
        self.weights = {}
        for m in sorted(walls):
            others_w = [float(walls[o]) for o in walls if o != m]
            base_w = statistics.median(others_w) if others_w else 0.0
            if base_w > 0 and float(walls[m]) > self.k * base_w:
                self._streak[m] = self._streak.get(m, 0) + 1
            else:
                self._streak[m] = 0
            if self.skew > 0 and self._streak[m] >= self.m:
                others_e = [self._ema[o] for o in walls if o != m]
                base_e = statistics.median(others_e) if others_e else 0.0
                ema = self._ema[m]
                ratio = base_e / ema if ema > 0 else 1.0
                self.weights[m] = max(1.0 - self.skew, ratio)
                if ratio <= 1.0 - self.skew:
                    self._pinned[m] = self._pinned.get(m, 0) + 1
                else:
                    self._pinned[m] = 0
            else:
                self.weights[m] = 1.0
                self._pinned[m] = 0

    def shares(self, batch_size: int, members: Sequence[int]) -> List[int]:
        """Per-member item counts summing to batch_size, in member order:
        the equal split (split_bounds) unless a straggler weight is
        active, then largest-remainder apportionment of the weighted
        shares, every member keeping at least one item."""
        B, n = int(batch_size), len(members)
        if B < n:
            raise ValueError(f"global batch of {B} cannot feed {n} members")
        w = [self.weights.get(m, 1.0) for m in members]
        if self.skew <= 0 or all(abs(x - 1.0) < 1e-12 for x in w):
            return [b - a for a, b in split_bounds(B, n)]
        _REBALANCES.inc()
        total_w = sum(w)
        raw = [B * x / total_w for x in w]
        out = [max(1, int(r)) for r in raw]
        while sum(out) > B:
            i = max(range(n), key=lambda j: (out[j] - raw[j], j))
            if out[i] <= 1:
                break
            out[i] -= 1
        while sum(out) < B:
            i = max(range(n), key=lambda j: (raw[j] - out[j], -j))
            out[i] += 1
        return out


def _tree_map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    if isinstance(tree, (list, tuple)):
        for x in tree:
            leaf = _first_leaf(x)
            if leaf is not None:
                return leaf
        return None
    if isinstance(tree, dict):
        return _first_leaf(list(tree.values()))
    return tree


def _like(arr: np.ndarray, grad: torch.Tensor) -> torch.Tensor:
    """A received array as a tensor of `grad`'s dtype (bf16 travels as its
    uint16 words), on `grad`'s device."""
    if grad.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(grad.device).view(grad.shape)


class ElasticTrainer:
    """Data-parallel training loop that survives rank loss by reforming
    and resharding the checkpoint (see the module note).

    Args:
        model / loss_fn / optimizer: as for jit.TrainStep; every member
            builds its own identically initialised copy.
        root: checkpoint root shared by all members (rank-sharded layout).
        store: the process-group store all members share.
        member_id: this member's id (any ints; dp ranks are their sorted
            order within the current view).
        members: the initial membership.
        save_every: sharded-checkpoint cadence in global steps.
        heartbeat_s / lease_ttl_s: liveness knobs (default: flags).
        allreduce_timeout_s: how long the exchange waits before naming the
            missing members (default: a few lease TTLs).
        sync_timeout_s: the checkpoint commit barrier's bound.
        rebalance_skew: bound for straggler rebalancing (default: flag;
            0 disables).
        eject_patience: consecutive windows a member may sit pinned at the
            rebalance clamp before it is auto-ejected (default:
            FLAGS_elastic_eject_patience; 0 disables).
        clock: injectable monotonic clock for the membership layer.
        device: as for TrainStep (None: the current CUDA device).
    """

    def __init__(self, model, loss_fn, optimizer, root: str, *,
                 store, member_id: int, members: Sequence[int],
                 save_every: int = 5, keep_last_n: int = 3,
                 heartbeat_s: Optional[float] = None,
                 lease_ttl_s: Optional[float] = None,
                 allreduce_timeout_s: Optional[float] = None,
                 sync_timeout_s: float = 20.0,
                 rebalance_skew: Optional[float] = None,
                 eject_patience: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        self.model = model
        self.optimizer = optimizer
        self.root = str(root)
        self.store = store
        self.member_id = int(member_id)
        self.save_every = int(save_every)
        self.keep_last_n = int(keep_last_n)
        self.sync_timeout_s = float(sync_timeout_s)
        # the state container and the forward/backward; its own update is
        # not used (the update must see the averaged gradients)
        self.step = TrainStep(model, loss_fn, optimizer, device=device,
                              nan_guard=False, telemetry=False)
        self.membership = ElasticMembership(
            store, member_id, members, lease_ttl_s=lease_ttl_s,
            heartbeat_s=heartbeat_s, clock=clock)
        self.reducer = StoreReducer(store, member_id)
        self.rebalancer = MicroBatchRebalancer(skew=rebalance_skew)
        self.eject_patience = int(
            get_flag("elastic_eject_patience")
            if eject_patience is None else eject_patience)
        self.allreduce_timeout_s = float(
            allreduce_timeout_s if allreduce_timeout_s is not None
            else max(3.0 * self.membership.lease_ttl_s, 2.0))
        self._gstep = 0
        self.losses: Dict[int, float] = {}     # step -> global loss (the
                                               # final value after replays)
        self.step_walls: List[Tuple[int, float, int, int]] = []
        # (step, this member's wall_s, gen, world) — every recorded step
        self.step_parts: List[Dict[str, Any]] = []
        self.saves: List[Dict[str, Any]] = []  # step, seconds of each save
        self.reforms: List[dict] = []
        self.manager = self._make_manager()

    # -- checkpoint plumbing ------------------------------------------------
    def _make_manager(self) -> CheckpointManager:
        v = self.membership.view
        return CheckpointManager(
            self.root, keep_last_n=self.keep_last_n, backend="sharded",
            store=self.store if v.world_size > 1 else None,
            rank=v.dp_rank(self.member_id), world_size=v.world_size,
            sync_timeout_s=self.sync_timeout_s,
            commit_namespace=f"g{v.gen}")

    def _state(self) -> Dict[str, Any]:
        return train_state(self.model, self.optimizer)

    def _meta(self) -> Dict[str, Any]:
        v = self.membership.view
        return {
            "step": int(self._gstep),
            "opt_step_count": int(self.optimizer._step_count),
            "gen": int(v.gen),
            "world_size": int(v.world_size),
            "members": list(v.members),
        }

    def _save(self) -> None:
        t0 = time.perf_counter()
        self.manager.save(self._gstep, self._state(), meta=self._meta())
        self.saves.append({"step": int(self._gstep),
                           "world_size": self.membership.view.world_size,
                           "seconds": time.perf_counter() - t0})

    def _restore(self):
        """Gather the full state from the newest committed rank-sharded
        checkpoint, whatever world size wrote it, into the live tensors (a
        host copy, then one copy a leaf to the device), and resume from
        its step: the resharding path (target_world_size=1)."""
        restored = self.manager.restore_latest(
            target_world_size=1, target_rank=0)
        if restored is None:
            return None
        load_train_state(self.model, self.optimizer, restored.state,
                         where=f"checkpoint {restored.path}")
        meta = restored.meta
        self._gstep = int(meta.get("step", restored.step))
        self.optimizer._step_count = int(
            meta.get("opt_step_count", self._gstep))
        return restored

    # -- reformation --------------------------------------------------------
    def _reform(self, view: MembershipView, detect_s: float = 0.0) -> None:
        """Membership changed: rebuild everything keyed on rank and world
        (checkpoint manager, the step's caches, rebalancer, reducer), then
        re-seed the full state from the last committed checkpoint."""
        _REFORM_STEPS.inc()
        self.manager = self._make_manager()
        self.step.invalidate_executables()
        self.rebalancer.reset()
        self.reducer.reset()
        at_step = self._gstep
        t0 = time.perf_counter()
        restored = self._restore()
        if restored is None:
            raise RuntimeError(
                f"member {self.member_id}: no committed checkpoint to "
                f"reform from at gen {view.gen} (root {self.root!r}); "
                f"the initial step-0 save should have guaranteed one")
        self.reforms.append({
            "gen": int(view.gen), "members": list(view.members),
            "world_size": int(view.world_size),
            "detected_at_step": int(at_step),
            "resumed_step": int(self._gstep),
            "dp_rank": self.membership.view.dp_rank(self.member_id),
            "detect_s": float(detect_s),
            "restore_s": time.perf_counter() - t0,
        })

    def _await_reform(self) -> Optional[MembershipView]:
        """After a PeerLostError (or a failed synchronised save): poll
        until the missing members' leases expire and a new view is agreed.
        None if the deadline passes with the membership unchanged (peers
        alive but slow: the caller retries the step)."""
        m = self.membership
        deadline = time.monotonic() + m.lease_ttl_s \
            + 4 * m.heartbeat_s + 2.0
        while time.monotonic() < deadline:
            changed = m.poll()
            if changed is not None:
                return changed
            time.sleep(max(m.heartbeat_s / 2, 0.01))
        return None

    # -- one global step ----------------------------------------------------
    def _sync(self) -> None:
        if self.step.device.type == "cuda":
            torch.cuda.synchronize(self.step.device)

    def _train_step(self, batch) -> None:
        view = self.membership.view
        members = view.members
        me = self.member_id
        idx = view.dp_rank(me)
        parts = dict.fromkeys(PARTS, 0.0)
        nbytes = {"sent": 0, "received": 0}
        t0 = time.perf_counter()
        delay = chaos.rank_delay(me)
        if delay > 0:  # injected straggler
            time.sleep(delay)
        leaf = _first_leaf(batch)
        if leaf is None:
            raise ValueError("empty batch")
        shares = self.rebalancer.shares(int(leaf.shape[0]), members)
        lo = sum(shares[:idx])
        hi = lo + shares[idx]
        shard = _tree_map(lambda x: x[lo:hi], batch)
        # a retried step (or one after a reform) starts from zero gradients
        self.optimizer.clear_grad()
        t = time.perf_counter()
        loss, grads = self.step.forward_backward(*shard)
        loss_f = float(loss)
        parts["fwd_bwd"] = time.perf_counter() - t
        others = [m for m in members if m != me]
        packed = None
        if others:
            t = time.perf_counter()
            host = [leaf.array for leaf in _host_copies(grads, copy=False)]
            parts["d2h"] = time.perf_counter() - t
        wall = time.perf_counter() - t0
        meta = {"n": int(hi - lo), "loss": loss_f, "wall_s": float(wall),
                "member": me}
        if others:
            t = time.perf_counter()
            packed = _pack(meta, host)
            del host
            parts["pack"] = time.perf_counter() - t
            t = time.perf_counter()
            nbytes["sent"] = packed.nbytes
            self.reducer.publish_packed(view.gen, self._gstep, packed)
            del packed
            parts["publish"] = time.perf_counter() - t
        # the weighted average in sorted member order (module note); the
        # weights are the shares every member computed alike
        total_n = sum(shares)
        global_loss = 0.0
        walls: Dict[int, float] = {}
        acc: Optional[List[torch.Tensor]] = None
        own_first = idx <= 1
        w_me = np.float32(meta["n"] / total_n)
        if own_first:
            for g in grads:
                g.mul_(float(w_me))
            acc = grads
        incoming = self.reducer.iter_raw(
            view.gen, self._gstep, others,
            timeout_s=self.allreduce_timeout_s)
        for i, m in enumerate(members):
            if m == me:
                c_meta = meta
                if not own_first:
                    for a, g in zip(acc, grads):
                        a.add_(g.mul_(float(w_me)))
            else:
                t = time.perf_counter()
                got, raw = next(incoming)
                parts["collect"] += time.perf_counter() - t
                t = time.perf_counter()
                nbytes["received"] += len(raw)
                c_meta, arrays = _unpack_iter(raw)
                if c_meta["n"] != shares[i]:
                    raise RuntimeError(
                        f"member {m} computed a share of {c_meta['n']} at "
                        f"step {self._gstep}, this member {shares[i]}")
                w = float(np.float32(c_meta["n"] / total_n))
                h2d = 0.0
                fresh = acc is None
                terms = [] if fresh else None
                for j, arr in enumerate(arrays):
                    th = time.perf_counter()
                    term = _like(arr, grads[j])
                    del arr
                    h2d += time.perf_counter() - th
                    term.mul_(w)
                    if fresh:
                        terms.append(term)
                    else:
                        acc[j].add_(term)
                if fresh:
                    acc = terms
                del raw, arrays
                self._sync()
                parts["h2d"] += h2d
                parts["unpack_average"] += time.perf_counter() - t - h2d
            global_loss += c_meta["loss"] * (c_meta["n"] / total_n)
            walls[m] = float(c_meta["wall_s"])
        if acc is not grads:
            for g, a in zip(grads, acc):
                g.copy_(a)
        del acc
        t = time.perf_counter()
        opt = self.optimizer
        clip, opt._grad_clip = opt._grad_clip, None
        try:
            opt.step()
        finally:
            opt._grad_clip = clip
        self._sync()
        parts["apply"] = time.perf_counter() - t
        self.rebalancer.observe(self._gstep, walls)
        self.losses[self._gstep] = float(global_loss)
        self.step_walls.append((self._gstep,
                                float(time.perf_counter() - t0),
                                int(view.gen), int(view.world_size)))
        self.step_parts.append({"step": int(self._gstep),
                                "gen": int(view.gen),
                                "world_size": int(view.world_size),
                                "parts": parts, "bytes": nbytes})

    # -- the loop -----------------------------------------------------------
    def run(self, batches: Sequence, *, total_steps: Optional[int] = None,
            resume: bool = True) -> Dict[str, Any]:
        """Train for `total_steps` global steps (default: len(batches)),
        cycling through `batches`. Returns a report whose "status" is
        "completed", "killed" (this member died to an armed chaos kill) or
        "ejected" (reformed out of the view). Survivors keep running
        through any number of membership changes."""
        batches = list(batches)
        total = int(total_steps) if total_steps is not None \
            else len(batches)
        me = self.member_id
        report: Dict[str, Any] = {
            "member": me, "status": "completed", "steps_run": 0,
            "retries": 0,
        }
        self.membership.start()
        try:
            restored = self._restore() if resume else None
            if restored is None:
                self._save()  # the step-0 rendezvous: a committed
                              # checkpoint exists before any failure can
            step_retries = 0
            while self._gstep < total:
                if chaos.should_kill_rank(me, self._gstep):
                    chaos.note_rank_killed(me)
                    self.membership.stop()  # heartbeat dies unannounced
                    report["status"] = "killed"
                    report["killed_at_step"] = int(self._gstep)
                    return report
                changed = self.membership.poll()
                if changed is not None:
                    if not changed.contains(me):
                        report["status"] = "ejected"
                        return report
                    self._reform(changed)
                    continue
                t_step = time.perf_counter()
                try:
                    self._train_step(batches[self._gstep % len(batches)])
                except PeerLostError as e:
                    view = self._await_reform()
                    if view is not None:
                        if not view.contains(me):
                            report["status"] = "ejected"
                            return report
                        self._reform(view, time.perf_counter() - t_step)
                        step_retries = 0
                        continue
                    if all(self.membership.is_alive(m) for m in e.missing) \
                            and step_retries < 10:
                        # peers heartbeat, just slow: retry the same step
                        # (republishing the same key overwrites it)
                        step_retries += 1
                        report["retries"] += 1
                        continue
                    raise
                step_retries = 0
                self._gstep += 1
                report["steps_run"] += 1
                if self._maybe_auto_eject(report):
                    continue            # reformed at N-1 inside
                if self.save_every and self._gstep < total \
                        and self._gstep % self.save_every == 0:
                    if not self._checked_save(report):
                        return report   # ejected while saving
            self._checked_save(report)
            return report
        finally:
            self.membership.stop()
            self._finalize_report(report)

    def _maybe_auto_eject(self, report: Dict[str, Any]) -> bool:
        """Flag-gated auto-ejection of a chronically slow member: once the
        rebalancer has pinned someone at the (1 - skew) clamp for
        `eject_patience` consecutive windows, remove it. Every member
        computes the same streaks, so all agree on the victim; the
        lowest-id non-straggler acts and the others adopt the new view
        through their own poll(). True when this member ejected someone
        and reformed."""
        patience = self.eject_patience
        if patience <= 0:
            return False
        view = self.membership.view
        if view.world_size <= 1:
            return False
        me = self.member_id
        victims = [m for m in view.members
                   if self.rebalancer.pinned_streak(m) >= patience]
        victims = [m for m in victims if m != me]
        if not victims:
            return False
        actor = min(m for m in view.members if m not in victims)
        if me != actor:
            return False                # the actor's tombstone reaches us
        victim = min(victims)           # one per window; streaks persist
        info = {
            "member": int(victim), "by": int(me),
            "step": int(self._gstep), "gen": int(view.gen),
            "pinned_windows": int(self.rebalancer.pinned_streak(victim)),
            "weight": float(self.rebalancer.weights.get(victim, 1.0)),
        }
        _EJECTIONS.inc()
        _flight.on_member_ejected(info)
        report.setdefault("ejections", []).append(info)
        new_view = self.membership.eject(victim)
        if new_view is not None and new_view.contains(me):
            self._reform(new_view)
            return True
        return False

    def _checked_save(self, report: Dict[str, Any]) -> bool:
        """A synchronised save can be where a death is first noticed (the
        barrier times out instead of the exchange): reform and carry on;
        the failed attempt never committed. It can also be where this
        member learns it was ejected: the report turns "ejected" and False
        comes back."""
        t0 = time.perf_counter()
        try:
            self._save()
        except TimeoutError:
            view = self._await_reform()
            if view is None:
                raise
            if not view.contains(self.member_id):
                report["status"] = "ejected"
                return False
            self._reform(view, time.perf_counter() - t0)
        return True

    def _finalize_report(self, report: Dict[str, Any]) -> None:
        v = self.membership.view
        report["step"] = int(self._gstep)
        report["final_gen"] = int(v.gen)
        report["final_world_size"] = int(v.world_size)
        report["final_members"] = list(v.members)
        report["reforms"] = list(self.reforms)
        report["losses"] = {int(k): float(self.losses[k])
                            for k in sorted(self.losses)}
        report["step_walls"] = [list(t) for t in self.step_walls]

"""Auto-resuming training loop over TrainStep (counterpart of
paddle_tpu/resilience/trainer.py).

The CheckpointManager's crash-consistent save/restore carries the
parameters, the optimizer state, the step counter, the RNG state and the
data loader's position; the PreemptionHandler turns SIGTERM into a final
checkpoint and a clean exit; TrainStep's NaN guard skips poisoned steps.
Restarting the same script resumes from the latest valid checkpoint.

The checkpointed state is the reference's tree (trainer.py:120-141):
{"params": [...], "buffers": [...], "opt_state": [...]}, the trainable
parameters in the model's order, then its buffers and frozen parameters,
and one dict a parameter of the optimizer's state: `moment1`, `moment2`,
`beta1_pow`, `beta2_pow`, `wd_on` and, under multi_precision, `master`.
The reference keeps that state in its compiled step; the port's TrainStep
updates the optimizer's own state in place, so the tree is built from the
optimizer's per-parameter views of its flat buffers (made at the first
save or restore if no step has run), and the host floats (beta powers,
wd_on) become 0-d float32 arrays as the reference's are. A restore copies
into those views in place, so a checkpoint the reference wrote resumes here
and the other way round.

`meta` keeps the reference's keys, except that the reference's
`core.random` [seed, counter] pair becomes "torch_rng": the states of the
model's own torch.Generators (the dropout masks' source), of torch's CPU
generator and, on a card, of its CUDA generator, restored on resume.

Left for later: `cluster=` (the cross-rank telemetry of the distributed
slice). The world-size check is kept; the manager's world size is 1.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from . import chaos
from .checkpoint_manager import CheckpointManager
from .preemption import PreemptionHandler
from ..jit.trainer import TrainStep
from ..nn.layers import module_generators
from ..observability import anomaly as _anomaly
from ..observability import flight_recorder as _flight
from ..observability import serve as _serve
from ..observability import telemetry as _telemetry

__all__ = ["ResilientTrainer"]


def _poison_first_float(batch):
    """Copy `batch` with a NaN planted in its first float leaf (the step
    then sees a really poisoned loss and gradients)."""
    done = [False]

    def rec(obj):
        if done[0]:
            return obj
        if torch.is_tensor(obj):
            if obj.is_floating_point() and obj.numel():
                t = obj.clone()
                t.view(-1)[0] = float("nan")
                done[0] = True
                return t
            return obj
        if isinstance(obj, np.ndarray):
            if np.issubdtype(obj.dtype, np.floating) and obj.size:
                arr = obj.copy()
                arr.flat[0] = np.nan
                done[0] = True
                return arr
            return obj
        if isinstance(obj, (list, tuple)):
            out = [rec(v) for v in obj]
            return tuple(out) if isinstance(obj, tuple) else out
        if isinstance(obj, dict):
            return {k: rec(v) for k, v in obj.items()}
        return obj

    return rec(batch)


def _hex(state: torch.Tensor) -> str:
    return bytes(state.numpy().tobytes()).hex()


def _unhex(s: str) -> torch.Tensor:
    return torch.frombuffer(bytearray(bytes.fromhex(s)), dtype=torch.uint8)


class ResilientTrainer:
    """TrainStep wrapper with periodic crash-consistent checkpoints,
    SIGTERM-clean exits, NaN-step skipping, and automatic resume.

    Args:
        model / loss_fn / optimizer: as for jit.TrainStep.
        manager: CheckpointManager (or a root path, turned into one).
        save_every: checkpoint cadence in global steps (0 = only final).
        preemption: PreemptionHandler to poll between steps; created (and
            installed by run()) when None.
        nan_guard: TrainStep's NaN/Inf step guard.
        backoff: optional amp.LossScaleBackoff (or any object with
            on_step(skipped: bool)) fed the guard verdict every step.
        anomaly_engine: observability.AnomalyEngine fed each completed step
            record; built from flags (FLAGS_anomaly) when None.
        step_kwargs: extra TrainStep kwargs (device, telemetry).
    """

    def __init__(self, model, loss_fn, optimizer,
                 manager: Union[CheckpointManager, str], *,
                 save_every: int = 100,
                 preemption: Optional[PreemptionHandler] = None,
                 nan_guard: bool = True,
                 backoff=None,
                 anomaly_engine=None,
                 cluster=None,
                 **step_kwargs):
        if cluster is not None:
            raise NotImplementedError(
                "ResilientTrainer(cluster=) is not ported yet (ROADMAP queue "
                "1: the distributed slice)")
        if isinstance(manager, str):
            manager = CheckpointManager(manager)
        self.manager = manager
        self.model = model
        self.optimizer = optimizer
        self.step = TrainStep(model, loss_fn, optimizer,
                              nan_guard=nan_guard, **step_kwargs)
        self.save_every = int(save_every)
        self.preemption = preemption
        self.backoff = backoff
        self.anomaly_engine = anomaly_engine
        self._epoch = 0
        self._offset = 0  # batches consumed in the current epoch
        self.resumed_from: Optional[int] = None

    # -- state <-> checkpoint ---------------------------------------------
    def _params(self):
        return [p for p in self.model.parameters() if p.requires_grad]

    def _buffers(self):
        return list(self.model.buffers()) + \
            [p for p in self.model.parameters() if not p.requires_grad]

    def _opt_states(self):
        """The optimizer's live per-parameter state dicts, in parameter
        order (made, with the flat buffers, if no step has run yet)."""
        opt = self.optimizer
        opt._materialize_state()
        return [opt._get_state(p) for p in self._params()]

    def _state(self) -> Dict[str, Any]:
        opt_state = []
        for st in self._opt_states():
            opt_state.append({
                k: (v if torch.is_tensor(v) else np.asarray(v, np.float32))
                for k, v in st.items()})
        return {
            "params": [p.detach() for p in self._params()],
            "buffers": [b.detach() for b in self._buffers()],
            "opt_state": opt_state,
        }

    def _rng_states(self) -> Dict[str, Any]:
        out = {"generators": [_hex(g.get_state())
                              for g in module_generators(self.model)],
               "cpu": _hex(torch.get_rng_state())}
        if self.step.device.type == "cuda":
            out["cuda"] = _hex(torch.cuda.get_rng_state(self.step.device))
        return out

    def _set_rng_states(self, saved: Dict[str, Any]) -> None:
        gens = module_generators(self.model)
        if len(saved.get("generators", ())) != len(gens):
            raise RuntimeError(
                f"checkpoint holds {len(saved.get('generators', ()))} "
                f"generator states, the model has {len(gens)}")
        for g, s in zip(gens, saved["generators"]):
            g.set_state(_unhex(s))
        torch.set_rng_state(_unhex(saved["cpu"]))
        if "cuda" in saved and self.step.device.type == "cuda":
            torch.cuda.set_rng_state(_unhex(saved["cuda"]), self.step.device)

    def _meta(self) -> Dict[str, Any]:
        return {
            "step": int(self.step._step_i),
            "opt_step_count": int(self.optimizer._step_count),
            "torch_rng": self._rng_states(),
            "epoch": int(self._epoch),
            "offset": int(self._offset),
            "skipped_steps": int(self.step.skipped_steps),
            # recorded so restore() can refuse a world-size mismatch loudly
            "world_size": int(self.manager.world_size),
        }

    def save(self):
        """Checkpoint of everything resume needs."""
        return self.manager.save(self.step._step_i, self._state(),
                                 meta=self._meta())

    @torch.no_grad()
    def restore(self):
        """Load the latest valid checkpoint into the live training state;
        returns the RestoredCheckpoint or None when starting fresh."""
        restored = self.manager.restore_latest(template=self._state())
        if restored is None:
            return None
        state, meta = restored.state, restored.meta
        saved_world = meta.get("world_size")
        cur_world = int(self.manager.world_size)
        if saved_world is not None and int(saved_world) != cur_world:
            raise RuntimeError(
                f"checkpoint {restored.path} (step {restored.step}) was "
                f"saved at world size {int(saved_world)} but this run has "
                f"world size {cur_world}: refusing to load misshaped "
                f"sharded state")
        params, buffers = self._params(), self._buffers()
        if len(state["params"]) != len(params) or \
                len(state["buffers"]) != len(buffers):
            raise RuntimeError(
                f"checkpoint {restored.path} holds "
                f"{len(state['params'])} parameters and "
                f"{len(state['buffers'])} buffers, the model "
                f"{len(params)} and {len(buffers)}")
        for p, v in zip(params, state["params"]):
            p.copy_(v)
        for b, v in zip(buffers, state["buffers"]):
            b.copy_(v)
        for live, saved in zip(self._opt_states(), state["opt_state"]):
            for k, v in saved.items():
                if k not in live:
                    continue
                if torch.is_tensor(live[k]):
                    live[k].copy_(v)
                else:
                    live[k] = float(v)
        self.step._step_i = int(meta.get("step", restored.step))
        self.optimizer._step_count = int(
            meta.get("opt_step_count", self.step._step_i))
        self.step.skipped_steps = int(meta.get("skipped_steps", 0))
        if "torch_rng" in meta:
            self._set_rng_states(meta["torch_rng"])
        self._epoch = int(meta.get("epoch", 0))
        self._offset = int(meta.get("offset", 0))
        self.resumed_from = restored.step
        return restored

    # -- loop --------------------------------------------------------------
    def run(self, batches: Union[Sequence, Callable[[], Iterable]], *,
            epochs: int = 1, resume: bool = True) -> Dict[str, Any]:
        """Train over `batches` (a sequence of batch tuples, or a callable
        returning a fresh iterable per epoch, e.g. ``lambda: loader``) for
        `epochs`, checkpointing every `save_every` steps.

        Auto-resumes from the latest valid checkpoint (step counter, RNG,
        epoch/offset replay-skip) when `resume`. Returns a report dict with
        status "completed" or "preempted"; on preemption a final checkpoint
        is committed before returning so the next run() continues cleanly.
        """
        if resume:
            self.restore()
        report = {
            "status": "completed",
            "steps_run": 0,
            "steps_skipped_start": int(self.step.skipped_steps),
            "resumed_from": self.resumed_from,
        }
        preempt = self.preemption
        installed_here = False
        if preempt is None:
            preempt = self.preemption = PreemptionHandler()
        if not preempt._installed:
            preempt.install()
            installed_here = True
        # per-step telemetry: this loop owns the phases TrainStep can't
        # see: the host's data wait before the step, the blocking
        # checkpoint time after it
        tele = _telemetry.get_telemetry() if _telemetry.enabled() else None
        if tele is not None:
            if self.anomaly_engine is None:
                self.anomaly_engine = _anomaly.from_flags()
            if self.anomaly_engine is not None:
                _serve.set_health_engine(self.anomaly_engine)
            _serve.maybe_start_from_flags()
        try:
            while self._epoch < epochs:
                it = iter(batches() if callable(batches) else batches)
                i = -1
                while True:
                    t_data = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                    i += 1
                    if i < self._offset:
                        continue  # replayed prefix of a resumed epoch
                    if tele is not None:
                        tele.pre_phase("data", time.perf_counter() - t_data)
                    if preempt.requested:
                        self._timed_save(tele)
                        report["status"] = "preempted"
                        report["preempt_reason"] = preempt.reason
                        return self._finish(report)
                    gstep = self.step._step_i
                    if chaos.should_poison(gstep):
                        batch = _poison_first_float(batch)
                        chaos.note_poisoned(gstep)
                    loss = self.step(*batch)
                    report["steps_run"] += 1
                    report["last_loss"] = float(loss)
                    if self.backoff is not None:
                        self.backoff.on_step(self.step.last_skipped)
                    if tele is not None:
                        rec = tele.last_record()
                        if rec is not None and \
                                self.anomaly_engine is not None:
                            self.anomaly_engine.observe(rec)
                    self._offset = i + 1
                    if self.save_every and \
                            self.step._step_i % self.save_every == 0:
                        self._timed_save(tele)
                self._epoch += 1
                self._offset = 0
            self._timed_save(tele)
            return self._finish(report)
        except BaseException as e:
            # black-box forensics for anything escaping the loop (chaos
            # InjectedCrash included); the exception itself propagates
            _flight.on_exception(e)
            raise
        finally:
            if installed_here:
                preempt.uninstall()

    def _timed_save(self, tele):
        t0 = time.perf_counter()
        out = self.save()
        if tele is not None:
            tele.post_phase("save", time.perf_counter() - t0)
        return out

    def _finish(self, report: Dict[str, Any]) -> Dict[str, Any]:
        self.manager.wait()  # run() must not return before the final commit
        report["step"] = int(self.step._step_i)
        report["steps_skipped"] = (int(self.step.skipped_steps)
                                   - report.pop("steps_skipped_start"))
        report["steps_skipped_total"] = int(self.step.skipped_steps)
        if _telemetry.enabled():
            tele = _telemetry.get_telemetry()
            tele.finalize()  # flush the staged record + Prometheus textfile
            report["telemetry"] = tele.summary()
        return report

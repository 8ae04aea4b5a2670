"""TrainSentinel: in-step model-health telemetry + NaN/Inf tripwire (the
counterpart of the JAX package's ``monitor/sentinel.py``).

Parity: ``FLAGS_check_nan_inf`` walks every op output and names the first
tensor that went nonfinite (framework/details/nan_inf_utils_detail.*); the
sentinel watches the MODEL beside the monitor's watch of the system:

- **the health bundle** (``traced_health``): an f32 vector on the device,
  ``[loss, grad_norm, update_ratio, param_norm, nonfinite, skipped,
  *per_subtree_nonfinite]``, computed from the step's own tensors after the
  executor's dispatch, in the reference's order.  The reference's
  ``lax.cond`` gate on the step seed is a host ``if`` on ``step %
  sample_every`` in the executor here, so an unsampled step launches
  nothing.  The inner "suspect" cond is a device-side ``torch.where``: the
  per-subtree nonfinite counts are always computed on a sampled step and
  selected only when the grad-norm square-sum + loss is nonfinite, so the
  vector costs no host sync until the host reads it.
- **the tripwire and its policies**: ``halt`` (default) raises
  ``NonFiniteError`` naming the first bad tensor (``localize_nonfinite``)
  and writes a flight postmortem, detection sampled; ``skip_batch`` keeps
  the pre-step value of every state tensor the step read and wrote
  (``traced_guard``: a ``torch.where`` per tensor, on the device, every
  step) and counts the skip (``monitor.health.skipped_batches``), reading
  the vector back every step; ``quarantine`` is ``skip_batch`` plus a
  committed debug checkpoint ``ckpt-<step>-quarantine`` (the shard/COMMIT
  protocol, ``parallel/checkpoint.py`` ``tag=``) holding the pre-step
  state and the offending feed batch — restore it and re-run the step for
  an offline repro.  Invisible to ``latest_checkpoint``/retention/GC, so
  resume never picks up a quarantined artifact.
- **divergence detectors** (copies): rolling robust z-score loss spikes,
  grad-norm explosion against the rolling median, loss plateaus, as
  ``monitor.health.{loss_spike,grad_explosion,plateau}`` counters and
  ``health_alert`` events.

Deterministic drills: the ``nan_batch`` chaos point (ft/chaos.py) poisons
the k-th executor feed with a NaN (``poison_feed``).  ``TrainLoop``
(``parallel/train.py``) feeds ``observe_loop`` its sampled loss.

Enable: ``sentinel.enable(policy=..., sample_every=...)`` or
``PADDLE_TPU_SENTINEL=1`` with ``PADDLE_TPU_SENTINEL_POLICY`` / ``_EVERY``;
with the sentinel off the executor runs exactly the step it runs without
it.
"""

import collections
import os
import time

import numpy as np

__all__ = ["Sentinel", "NonFiniteError", "enable", "disable",
           "active_sentinel", "traced_health", "traced_guard",
           "localize_nonfinite", "record_nonfinite", "poison_feed",
           "subtree_of", "HEALTH_SLOTS",
           "LossSpikeDetector", "GradExplodeDetector", "PlateauDetector"]

# fixed slots of the health vector; per-subtree nonfinite counts follow
HEALTH_SLOTS = ("loss", "grad_norm", "update_ratio", "param_norm",
                "nonfinite", "skipped")
IDX_LOSS, IDX_GRAD_NORM, IDX_UPDATE_RATIO, IDX_PARAM_NORM, \
    IDX_NONFINITE, IDX_SKIPPED = range(6)
N_FIXED = len(HEALTH_SLOTS)

POLICIES = ("halt", "skip_batch", "quarantine")


class NonFiniteError(RuntimeError):
    """The tripwire fired under the ``halt`` policy.  Carries the evidence
    so callers (and tests) need not re-parse the message."""

    def __init__(self, msg, step=None, first=None, postmortem=None,
                 quarantine=None):
        super().__init__(msg)
        self.step = step
        self.first = first            # name of the first localized tensor
        self.postmortem = postmortem  # flight-recorder dump path
        self.quarantine = quarantine  # committed quarantine ckpt path


def subtree_of(name):
    """Telemetry grouping key for a parameter name: the reference's
    per-tensor localization rolls up per LAYER here ("fc_0.w_0" and
    "fc_0.b_0" are one "fc_0" subtree) so the in-step bundle stays a
    handful of floats on a thousand-parameter model."""
    return name.split(".", 1)[0].split("@", 1)[0]


# -- the bundle on device tensors ---------------------------------------------

def traced_health(loss, grads, old_params, new_params):
    """The health vector on the step's device.

    loss:       the step's loss tensor (any float dtype, summed)
    grads:      {param_name: grad tensor} (SelectedRows callers pass .values)
    old_params: {name: pre-update value} — the update/param ratio's base
    new_params: {name: post-update value} for the names in old_params

    Returns ``(vec, subtree_names)``: vec is f32 ``[loss, grad_norm,
    update_ratio, param_norm, nonfinite, skipped=0,
    *per_subtree_nonfinite]``, computed in the reference's order (grads
    grouped by subtree, sorted by name); the update/param ratio tracks the
    LARGEST parameter (the first of equal sizes, in ``old_params``' order)
    as the representative.  The per-subtree counts are selected by a
    ``torch.where`` on ``isfinite(grad-norm square-sum + loss)``, the
    reference's ``lax.cond`` predicate."""
    import torch

    f32 = torch.float32
    groups = {}
    for name in sorted(grads):
        groups.setdefault(subtree_of(name), []).append(grads[name])
    names = sorted(groups)
    device = loss.device
    zero = torch.zeros((), dtype=f32, device=device)
    sq = zero
    for n in names:
        for g in groups[n]:
            gf = g.float()
            sq = sq + torch.sum(gf * gf)
    grad_norm = torch.sqrt(sq)
    loss_f = torch.sum(loss.float())
    suspect = ~torch.isfinite(sq + loss_f)
    if names:
        counts = torch.stack([
            sum((torch.sum((~torch.isfinite(g.float())).to(f32))
                 for g in groups[n]), zero) for n in names])
        per_subtree = torch.where(suspect, counts, torch.zeros_like(counts))
    else:
        per_subtree = torch.zeros((0,), dtype=f32, device=device)
    total_nf = torch.sum(per_subtree) + (~torch.isfinite(loss_f)).to(f32)
    update_ratio = zero
    param_norm = zero
    rep = max((k for k in old_params if k in new_params),
              key=lambda k: int(np.prod(tuple(old_params[k].shape) or (1,))),
              default=None)
    if rep is not None:
        of = old_params[rep].float()
        d = new_params[rep].float() - of
        param_norm = torch.sqrt(torch.sum(of * of))
        update_ratio = torch.sqrt(torch.sum(d * d)) / (param_norm + 1e-12)
    return torch.cat([torch.stack([loss_f, grad_norm, update_ratio,
                                   param_norm, total_nf, zero]),
                      per_subtree]), names


def traced_guard(vec, state_in, state_out):
    """The skip_batch on-device revert: when the bundle shows nonfinite,
    every state tensor the step READ AND wrote takes its pre-step value
    (a ``torch.where`` on the device; write-only outputs pass through).
    Sets the vector's ``skipped`` slot."""
    import torch

    bad = vec[IDX_NONFINITE] > 0
    guarded = {}
    for n, v in state_out.items():
        old = state_in.get(n)
        if old is not None and getattr(old, "shape", None) == v.shape:
            guarded[n] = torch.where(bad, old.to(v.dtype), v)
        else:
            guarded[n] = v
    vec = vec.clone()
    vec[IDX_SKIPPED] = bad.to(vec.dtype)
    return guarded, vec


# -- host-side localization ---------------------------------------------------

def _as_float_numpy(arr):
    """Host numpy copy of a float tensor, or None for non-float dtypes.
    bfloat16 (no native numpy ufunc coverage) widens to f32."""
    if hasattr(arr, "detach"):               # a torch tensor, on any device
        if not arr.is_floating_point():
            return None
        arr = arr.detach()
        return (arr.float() if arr.dtype.itemsize < 4 else arr).cpu().numpy()
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    if a.dtype.kind != "f":
        return None
    return a


def localize_nonfinite(named):
    """The diagnostic pass (nan_inf_utils_detail parity): given an iterable
    of ``(name, array)``, materialize each float tensor and report every
    nonfinite one — ``{"name", "nan", "inf", "first_index", "shape",
    "dtype"}`` in input order, so ``[0]`` is the FIRST bad tensor.  Returns
    ``[]`` when everything is finite."""
    out = []
    for name, arr in named:
        a = _as_float_numpy(arr)
        if a is None:
            continue
        finite = np.isfinite(a)
        if finite.all():
            continue
        n_nan = int(np.isnan(a).sum())
        n_inf = int(np.isinf(a).sum())
        first = int(np.argmax(~finite.reshape(-1)))
        out.append({"name": name, "nan": n_nan, "inf": n_inf,
                    "first_index": first,
                    "shape": list(np.shape(a)),
                    "dtype": str(arr.dtype).replace("torch.", "")})
    return out


def record_nonfinite(bad, registry=None):
    """Count a localized nonfinite hit (``monitor.health.nonfinite`` — one
    per offending STEP, not per element) — shared by the sentinel trip path
    and the ``FLAGS_check_nan_inf`` executor check, monitor session or
    not."""
    if registry is None:
        from .registry import default_registry

        registry = default_registry()
    registry.counter("monitor.health.nonfinite").incr()
    for b in bad[:8]:
        registry.counter("monitor.health.nonfinite_tensor",
                         tensor=b["name"]).incr()


def poison_feed(feed_arrays):
    """The ``nan_batch`` chaos payload: NaN the first element of the first
    float feed (name order), on a copy of the feed tensor — a drill pays
    that copy, the clean path never runs this."""
    for name in sorted(feed_arrays):
        a = feed_arrays[name]
        if a.is_floating_point():
            a = a.clone()
            a.view(-1)[:1] = float("nan")
            out = dict(feed_arrays)
            out[name] = a
            return out
    import warnings

    warnings.warn("chaos nan_batch: no float feed to poison; batch "
                  "unchanged")
    return feed_arrays


# -- divergence detectors -----------------------------------------------------

class LossSpikeDetector:
    """Rolling ROBUST z-score on the sampled loss: z = (x - median) /
    (1.4826 * MAD).  Median/MAD, not mean/std, so a spike cannot inflate its
    own baseline — the next spike still fires — and noisy-but-healthy loss
    (MAD tracks the noise floor) stays quiet."""

    kind = "loss_spike"

    def __init__(self, window=64, z_thresh=8.0, min_n=16):
        self.window = collections.deque(maxlen=int(window))
        self.z_thresh = float(z_thresh)
        self.min_n = int(min_n)

    def observe(self, value):
        """Returns the z-score when a spike fired, else None."""
        fired = None
        if len(self.window) >= self.min_n:
            med = float(np.median(self.window))
            mad = float(np.median(np.abs(np.asarray(self.window) - med)))
            z = (value - med) / (1.4826 * mad + 1e-12)
            if z > self.z_thresh:
                fired = round(z, 2)
        self.window.append(float(value))
        return fired


class GradExplodeDetector:
    """Grad-norm explosion: the sampled global grad norm exceeds
    ``factor`` x its rolling median."""

    kind = "grad_explosion"

    def __init__(self, window=64, factor=50.0, min_n=16):
        self.window = collections.deque(maxlen=int(window))
        self.factor = float(factor)
        self.min_n = int(min_n)

    def observe(self, value):
        fired = None
        if len(self.window) >= self.min_n:
            med = float(np.median(self.window))
            if med > 0 and value > self.factor * med:
                fired = round(value / med, 2)
        self.window.append(float(value))
        return fired


class PlateauDetector:
    """Loss plateau: over the last ``window`` samples, the median of the
    newer half improved on the older half by less than ``rel_eps``
    (relative).  Fires once per plateau stretch (re-arms when improvement
    resumes)."""

    kind = "plateau"

    def __init__(self, window=200, rel_eps=1e-3):
        self.window = collections.deque(maxlen=int(window))
        self.rel_eps = float(rel_eps)
        self._armed = True

    def observe(self, value):
        self.window.append(float(value))
        if len(self.window) < self.window.maxlen:
            return None
        half = len(self.window) // 2
        vals = np.asarray(self.window)
        older = float(np.median(vals[:half]))
        newer = float(np.median(vals[half:]))
        improvement = (older - newer) / max(abs(older), 1e-12)
        if improvement < self.rel_eps:
            if self._armed:
                self._armed = False
                return round(improvement, 6)
            return None
        self._armed = True
        return None


# -- the sentinel session -----------------------------------------------------

def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class Sentinel:
    """One monitor session's model-health watcher.  Constructed by
    ``sentinel.enable()`` (or auto, ``PADDLE_TPU_SENTINEL=1`` at
    ``monitor.enable`` time); the executor asks it whether a step is
    sampled (``wants_health``) and hands it the vector after the dispatch,
    before the state commits to the scope."""

    def __init__(self, monitor, policy=None, sample_every=None,
                 quarantine_dir=None, spike_window=64, spike_z=8.0,
                 spike_min=16, explode_factor=50.0, plateau_window=200,
                 plateau_eps=1e-3, export_every_secs=5.0,
                 max_postmortems=3, max_quarantines=2):
        policy = policy or os.environ.get(
            "PADDLE_TPU_SENTINEL_POLICY", "halt").strip() or "halt"
        if policy not in POLICIES:
            raise ValueError("sentinel policy %r (known: %s)"
                             % (policy, ", ".join(POLICIES)))
        self.monitor = monitor
        self.policy = policy
        every = max(
            int(sample_every) if sample_every is not None
            else _env_int("PADDLE_TPU_SENTINEL_EVERY", 8), 1)
        # rounded UP to a power of two, the reference's cadence (its gate
        # on the step seed needs a divisor of 2**32)
        self.sample_every = 1 << (every - 1).bit_length()
        self.quarantine_dir = (quarantine_dir
                               or os.environ.get("PADDLE_TPU_SENTINEL_QDIR")
                               or os.path.join(monitor.out_dir, "quarantine"))
        self.export_every_secs = float(export_every_secs)
        self.max_postmortems = int(max_postmortems)
        self.max_quarantines = int(max_quarantines)
        self.detectors = [
            LossSpikeDetector(spike_window, spike_z, spike_min),
            GradExplodeDetector(spike_window, explode_factor, spike_min),
        ]
        self._plateau = PlateauDetector(plateau_window, plateau_eps)
        self._seen = 0
        self._loop_seen = 0
        self._trips = 0
        self._postmortems = 0
        self._quarantines = 0
        self._rate_ref = None          # (step, perf_counter) of last sample
        self._export_next = 0.0

    # -- executor contract -------------------------------------------------
    @property
    def guard_on_device(self):
        return self.policy in ("skip_batch", "quarantine")

    def wants_health(self, step):
        """Whether the executor computes the bundle for ``step``: every
        step under ``skip_batch``, else every ``sample_every``-th — an
        unsampled step launches nothing for the sentinel."""
        return self.guard_on_device or step % self.sample_every == 0

    def after_step(self, step, health, names, state_out=None, fetches=None,
                   fetch_names=None, feed=None, ident=None):
        """The executor's post-dispatch hook.  ``health`` is the step's
        device vector, computed (and read back) only on sample boundaries,
        except under ``skip_batch``, whose exact per-batch counting needs
        every step's verdict (one small readback a step).  May raise
        NonFiniteError (halt policy)."""
        self._seen += 1
        if self.guard_on_device:
            sample_due = (self._seen - 1) % self.sample_every == 0
        else:
            sample_due = step % self.sample_every == 0
            if not sample_due:
                return
        vec = health.detach().double().cpu().numpy()
        names = list(names or [])
        if sample_due:
            self._record_sample(step, vec, names)
        skipped = vec[IDX_SKIPPED] > 0
        tripped = vec[IDX_NONFINITE] > 0 and not self.guard_on_device
        if skipped or tripped:
            self._trip(step, vec, names, state_out=state_out,
                       fetches=fetches, fetch_names=fetch_names,
                       feed=feed, ident=ident)

    # -- TrainLoop / raw-loop contract -------------------------------------
    def observe_loop(self, step, aux):
        """Sampled loss observation for step loops (parallel/train.py
        TrainLoop): every ``sample_every``-th step the scalar aux is read
        back (a sync — same sampling discipline as the executor path) and
        feeds the gauges + divergence detectors.  A nonfinite loss trips:
        ``halt`` raises; the skip policies cannot un-apply an update the
        step already made in place, so they count the hit and keep going."""
        self._loop_seen += 1
        if (self._loop_seen - 1) % self.sample_every != 0:
            return
        if aux is None or not hasattr(aux, "dtype") \
                or int(np.prod(getattr(aux, "shape", ()) or (1,))) != 1:
            return
        if hasattr(aux, "detach"):
            aux = aux.detach().double().cpu().numpy()
        loss = float(np.asarray(aux).reshape(()))
        vec = np.zeros(N_FIXED)
        vec[IDX_LOSS] = loss
        vec[IDX_GRAD_NORM] = np.nan
        vec[IDX_NONFINITE] = 0.0 if np.isfinite(loss) else 1.0
        self._record_sample(step, vec, [])
        if not np.isfinite(loss):
            self._trip(step, vec, [], state_out=None, fetches=None,
                       fetch_names=None, feed=None, ident="loop")

    def on_run_start(self, train=True):
        """train_from_dataset / TrainLoop run bracket: restart the steps/s
        window so a resumed or back-to-back run does not report rates
        across the gap."""
        self._rate_ref = None

    # -- sampling ----------------------------------------------------------
    def _record_sample(self, step, vec, names):
        reg = self.monitor.registry
        now = time.perf_counter()
        loss, gnorm = vec[IDX_LOSS], vec[IDX_GRAD_NORM]
        reg.gauge("monitor.health.step").set(step)
        reg.gauge("monitor.health.loss").set(
            loss if np.isfinite(loss) else 0.0)
        if np.isfinite(gnorm):
            reg.gauge("monitor.health.grad_norm").set(gnorm)
            reg.histogram("monitor.health.grad_norm_sampled").observe(gnorm)
        if np.isfinite(vec[IDX_UPDATE_RATIO]):
            reg.gauge("monitor.health.update_ratio").set(
                vec[IDX_UPDATE_RATIO])
        reg.gauge("monitor.health.nonfinite_last").set(vec[IDX_NONFINITE])
        if np.isfinite(loss):
            reg.histogram("monitor.health.loss_sampled").observe(loss)
        if self._rate_ref is not None and step > self._rate_ref[0] \
                and now > self._rate_ref[1]:
            rate = (step - self._rate_ref[0]) / (now - self._rate_ref[1])
            reg.gauge("monitor.health.steps_per_sec").set(round(rate, 3))
        self._rate_ref = (step, now)
        ev = {"step": int(step), "loss": _j(loss), "grad_norm": _j(gnorm),
              "update_ratio": _j(vec[IDX_UPDATE_RATIO]),
              "nonfinite": int(vec[IDX_NONFINITE]),
              "skipped": int(vec[IDX_SKIPPED])}
        bad_subtrees = {n: int(c) for n, c in zip(names, vec[N_FIXED:])
                        if c > 0}
        if bad_subtrees:
            ev["bad_subtrees"] = bad_subtrees
        self.monitor.timeline.emit("health", **ev)
        # detectors see only FINITE samples (the tripwire owns nonfinite)
        if np.isfinite(loss):
            for det, val in ((self.detectors[0], loss),
                             (self._plateau, loss)):
                fired = det.observe(val)
                if fired is not None:
                    self._alert(det.kind, step, loss, fired)
        if np.isfinite(gnorm):
            fired = self.detectors[1].observe(gnorm)
            if fired is not None:
                self._alert(self.detectors[1].kind, step, gnorm, fired)
        if now >= self._export_next:
            # live-console feed: the gauges above are only scraped from
            # metrics.prom, which otherwise lands at disable(); a periodic
            # refresh (+ timeline flush) is what fleet_top tails mid-run
            self._export_next = now + self.export_every_secs
            try:
                self.monitor.export_prometheus()
                self.monitor.timeline.flush()
            except Exception:
                pass

    def _alert(self, kind, step, value, score):
        self.monitor.registry.counter("monitor.health." + kind).incr()
        self.monitor.timeline.emit("health_alert", kind=kind, step=int(step),
                                   value=_j(value), score=_j(score))

    # -- the tripwire ------------------------------------------------------
    def _trip(self, step, vec, names, state_out, fetches, fetch_names,
              feed, ident):
        """A nonfinite (or on-device-skipped) step: localize, record,
        preserve evidence, apply the policy."""
        reg = self.monitor.registry
        self._trips += 1
        named = []
        if state_out:
            named.extend(sorted(state_out.items()))
        if fetches is not None and fetch_names:
            named.extend(zip(fetch_names, fetches))
        bad = localize_nonfinite(named)
        record_nonfinite(bad, reg)
        bad_subtrees = {n: int(c) for n, c in zip(names, vec[N_FIXED:])
                        if c > 0}
        first = (bad[0]["name"] if bad
                 else (sorted(bad_subtrees) or ["loss"])[0])
        health_rec = {
            "step": int(step), "policy": self.policy, "ident": ident,
            "first_bad": first, "bundle": self.decode(vec, names),
            "bad_subtrees": bad_subtrees, "localization": bad,
        }
        quarantine_path = None
        if self.policy == "quarantine" \
                and self._quarantines < self.max_quarantines:
            self._quarantines += 1
            try:
                quarantine_path = self._commit_quarantine(
                    step, state_out, feed)
                health_rec["quarantine"] = quarantine_path
                reg.counter("monitor.health.quarantines").incr()
            except Exception as e:       # evidence is best-effort
                health_rec["quarantine_error"] = str(e)[:200]
        post_path = None
        if self._postmortems < self.max_postmortems:
            self._postmortems += 1
            flight = getattr(self.monitor, "flight", None)
            if flight is not None:
                try:
                    post_path = flight.dump(exc=(None, None, None),
                                            reason="nonfinite",
                                            extra={"health": health_rec})
                except Exception:
                    pass
        self.monitor.timeline.emit(
            "health_trip", step=int(step), policy=self.policy, first=first,
            nonfinite=int(vec[IDX_NONFINITE]) or None,
            skipped=int(vec[IDX_SKIPPED]),
            postmortem=post_path, quarantine=quarantine_path)
        self.monitor.timeline.flush()
        if self.guard_on_device:
            reg.counter("monitor.health.skipped_batches").incr()
            return                      # state already reverted on device
        msg = ("sentinel: nonfinite model state at step %d — first bad "
               "tensor %r (%s)%s" % (
                   step, first,
                   ", ".join("%s: %d nonfinite" % (n, c)
                             for n, c in sorted(bad_subtrees.items()))
                   or "loss nonfinite",
                   "; postmortem %s" % post_path if post_path else ""))
        raise NonFiniteError(msg, step=int(step), first=first,
                             postmortem=post_path,
                             quarantine=quarantine_path)

    def _commit_quarantine(self, step, state_out, feed):
        """Commit ``ckpt-<step>-quarantine`` (shard/COMMIT, tagged): the
        PRE-step state (the on-device guard already reverted state_out) plus
        the offending feed batch — restore + one step = the repro."""
        from ..parallel import checkpoint as _ckpt

        tree = {"scope": dict(state_out or {}),
                "feed": dict(feed or {}),
                "meta": {"step": np.int64(step)}}
        _ckpt.save_checkpoint(self.quarantine_dir, tree, step=int(step),
                              asynchronous=False, tag="quarantine")
        return os.path.join(self.quarantine_dir,
                            "ckpt-%d-quarantine" % int(step))

    # -- misc --------------------------------------------------------------
    @staticmethod
    def decode(vec, names):
        """Human form of a health vector (postmortems, tests)."""
        vec = np.asarray(vec, np.float64)
        out = {k: _j(vec[i]) for i, k in enumerate(HEALTH_SLOTS)}
        out["subtree_nonfinite"] = {n: int(c)
                                    for n, c in zip(names, vec[N_FIXED:])}
        return out

    def close(self):
        try:
            self.monitor.export_prometheus()
        except Exception:
            pass


def _j(v):
    """JSON-safe float (NaN/Inf are not valid JSON)."""
    v = float(v)
    return round(v, 6) if np.isfinite(v) else None


# -- module-level session management -----------------------------------------

def enable(**kwargs):
    """Attach a Sentinel to the active monitor session (enabling one when
    none is active).  Returns the Sentinel."""
    from . import session

    mon = session.active()
    if mon is None:
        mon = session.enable()
    if getattr(mon, "sentinel", None) is not None:
        mon.sentinel.close()
    mon.sentinel = Sentinel(mon, **kwargs)
    return mon.sentinel


def disable():
    """Detach the sentinel from the active session (the monitor keeps
    running); the executor's next run computes no bundle."""
    from . import session

    mon = session.active()
    if mon is not None and getattr(mon, "sentinel", None) is not None:
        mon.sentinel.close()
        mon.sentinel = None


def active_sentinel():
    """The active session's Sentinel, or None — THE hook-site check."""
    from . import session

    mon = session.active()
    return getattr(mon, "sentinel", None) if mon is not None else None

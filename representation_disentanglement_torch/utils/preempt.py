"""Preemption-safe training: catch SIGTERM/SIGINT, stop at a step boundary
(a copy of the JAX package's ``utils/preempt.py``).

Cloud machines are preempted (maintenance events and spot reclamation send
SIGTERM with a short grace window).  The reference has no story here — a
kill mid-epoch loses everything since the last end-of-epoch checkpoint
(src/main_missing.py:326-335 saves only after validation).  Here the
training loops run under a ``PreemptionGuard``: the first
signal sets a flag that the loops poll at optimizer-step boundaries, save
an atomic ``preempt.ckpt`` (tagged with the last *completed* epoch, so a
resume replays the interrupted epoch — at-least-once semantics keep the
optimizer/scheduler state exactly consistent with what a full-epoch
checkpoint would hold), and exit cleanly.  A second signal escalates to
the default handler (immediate termination) so a stuck step can't block
the grace window.

Resume: ``latest_resume_checkpoint`` prefers ``preempt.ckpt`` over the
configured checkpoint when it is the more recent epoch; the loops delete
the preempt file once a regular end-of-epoch checkpoint at the same or a
later epoch lands.
"""

from __future__ import annotations

import os
import signal
from typing import Optional, Tuple

PREEMPT_NAME = "preempt.ckpt"


class PreemptionGuard:
    """Context manager: install handlers for ``signals`` that set a flag.

    Poll ``guard.requested`` at safe boundaries.  Handlers are restored on
    exit.  A second delivery of the same signal re-raises with the default
    disposition (kill) so the grace window can't be out-waited by a hung
    device step.  Tests can inject a trigger by calling ``request()``.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._prev = {}
        self._requested = False

    # -- context manager ---------------------------------------------------
    def __enter__(self) -> "PreemptionGuard":
        for sig in self._signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except ValueError:
                # signal.signal only works on the main thread of the main
                # interpreter; off it, degrade to an inert guard (requested
                # stays pollable via request()) instead of breaking train()
                print("[preempt] not on the main thread; signal handlers "
                      "not installed (cooperative request() still works)",
                      flush=True)
                break
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
        return None

    # -- signal plumbing ----------------------------------------------------
    def _handle(self, signum, frame) -> None:
        if self._requested:
            # second signal: restore default disposition and re-deliver —
            # the caller is not draining fast enough
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        self._requested = True
        print(f"[preempt] caught signal {signum}; will checkpoint and stop "
              "at the next step boundary", flush=True)

    def request(self) -> None:
        """Programmatic trigger (tests, cooperative shutdown)."""
        self._requested = True

    @property
    def requested(self) -> bool:
        return self._requested


def preempt_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, PREEMPT_NAME)


def tag_preempt_epoch(ckpt_dir: str, epoch: int) -> None:
    """Write the cheap sidecar ``preempt.ckpt.epoch`` next to the preempt
    checkpoint so ``clear_stale_preempt`` can compare epochs without
    deserializing the full params/opt-state blob."""
    final = preempt_path(ckpt_dir) + ".epoch"
    tmp = final + ".tmp"
    try:
        with open(tmp, "w") as f:
            f.write(str(int(epoch)))
        os.replace(tmp, final)  # atomic: never a torn/stale-visible sidecar
    except OSError:
        pass


def drop_preempt_sidecar(ckpt_dir: str) -> None:
    """Remove any existing epoch sidecar BEFORE writing a new preempt.ckpt.
    If the process dies between the checkpoint write and the new tag write,
    the slow path then reads the true epoch from the checkpoint itself
    instead of trusting a stale tag from an earlier preemption."""
    try:
        os.remove(preempt_path(ckpt_dir) + ".epoch")
    except OSError:
        pass


def _preempt_epoch(ckpt_dir: str) -> int:
    """Epoch tag of the on-disk preempt.ckpt: sidecar if present, else the
    full checkpoint (slow path, pre-sidecar files)."""
    try:
        with open(preempt_path(ckpt_dir) + ".epoch") as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        pass
    try:
        from representation_disentanglement_torch.training.checkpoint import (
            load_checkpoint)
        return int(load_checkpoint(ckpt_dir, PREEMPT_NAME).get("epoch", -1))
    except Exception:
        # Fail CLOSED: the preempt file exists but its epoch cannot be
        # determined (transient read/parse failure) — never treat that as
        # "ancient" and let clear_stale_preempt delete state it could not
        # inspect.
        import sys
        return sys.maxsize


def clear_stale_preempt(ckpt_dir: str, completed_epoch: int) -> None:
    """Drop ``preempt.ckpt`` once a regular checkpoint at
    ``completed_epoch`` >= the preempt's tagged epoch has been written.
    The guard matters for a fresh run launched (without --resume) into a
    directory that still holds a newer preempted state: its early epochs
    must not delete the only copy of the newest params."""
    p = preempt_path(ckpt_dir)
    if not os.path.exists(p):
        return
    # Strict inequality: latest_resume_checkpoint prefers the preempt file on
    # an epoch TIE (it holds extra partial-epoch progress), so deletion must
    # require a strictly newer regular checkpoint or a fresh run reaching
    # epoch == tag would delete state that resume would have chosen.
    if int(completed_epoch) <= _preempt_epoch(ckpt_dir):
        return
    for path in (p, p + ".epoch"):
        try:
            os.remove(path)
        except OSError:
            pass


def latest_resume_checkpoint(ckpt_dir: str, ckpt_name: str
                             ) -> Tuple[str, Optional[dict]]:
    """Pick the resume source: ``preempt.ckpt`` if present and at least as
    recent (by stored epoch) as the configured checkpoint, else
    ``ckpt_name``.  Returns (chosen_name, preloaded_dict_or_None) — the
    dict is returned when the choice required reading files, so callers
    don't deserialize twice."""
    from representation_disentanglement_torch.training.checkpoint import (
        load_checkpoint)
    pp = preempt_path(ckpt_dir)
    if not os.path.exists(pp):
        return ckpt_name, None
    pre = load_checkpoint(ckpt_dir, PREEMPT_NAME)
    named = os.path.join(ckpt_dir, ckpt_name)
    if os.path.exists(named):
        reg = load_checkpoint(ckpt_dir, ckpt_name)
        if int(reg.get("epoch", -1)) > int(pre.get("epoch", -1)):
            return ckpt_name, reg
    print(f"[preempt] resuming from {PREEMPT_NAME} "
          f"(epoch {int(pre.get('epoch', -1))})", flush=True)
    return PREEMPT_NAME, pre

"""Activation sharding constraints.

Counterpart of ``repro/parallel/act.py``.  The reference pins the layouts
of the residual stream, the logits and the attention heads at block
boundaries with ``with_sharding_constraint``, under a process-global
policy the launcher installs, because GSPMD's propagation from the
parameter shardings alone goes wrong inside its scanned, rematerialized
stack.

The port has no GSPMD.  Its sharded train step
(:func:`repro_torch.train.make_train_step` with a mesh) gathers the full
parameters on every rank and runs the model on the rank's own rows of the
batch, so every activation a rank computes is whole and local: there is
no layout to pin.  The policy is kept, with the reference's interface,
and :func:`shard_act` returns ``x`` unchanged; the layers do not call it.

Names of the reference's policy: ``residual`` [B, S, D], ``logits``
[B, S, V], ``heads`` [B, H, S, D].
"""

from __future__ import annotations

import contextlib

_POLICY: dict = {}


def set_policy(policy: dict) -> None:
    global _POLICY
    _POLICY = dict(policy)


def get_policy() -> dict:
    return dict(_POLICY)


def clear_policy() -> None:
    global _POLICY
    _POLICY = {}


@contextlib.contextmanager
def policy(p: dict):
    old = get_policy()
    set_policy(p)
    try:
        yield
    finally:
        set_policy(old)


def shard_act(x, name: str):
    """``x`` itself: a rank's activations are whole and local (see the
    module's docstring), whatever the policy names."""
    return x


__all__ = ["clear_policy", "get_policy", "policy", "set_policy",
           "shard_act"]

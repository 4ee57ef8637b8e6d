"""Activation recompute (counterpart of
``paddle_tpu/distributed/fleet/recompute/recompute.py``).

``recompute(fn, *args)`` runs ``fn`` without keeping its activations and
runs it again in the backward, through ``torch.utils.checkpoint``
(non-reentrant, the RNG state preserved so a replayed dropout draws the
same mask): the ``remat="full"`` of the training rung.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

__all__ = ["recompute"]


def recompute(function, *args, preserve_rng_state: bool = True,
              use_reentrant: bool = True, policy=None, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    the backward. ``use_reentrant`` is accepted for Paddle's signature;
    the port always takes torch's non-reentrant form. ``policy`` (a JAX
    ``checkpoint_policies`` predicate, ``remat="dots"``) is not
    ported."""
    if policy is not None:
        raise NotImplementedError(
            "recompute(policy=...) (the remat='dots' saveable policy) "
            "comes with the selective-recompute slice of the port")
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **kwargs)

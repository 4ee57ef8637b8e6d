"""Activation recompute (counterpart of
``paddle_tpu/distributed/fleet/recompute/recompute.py``).

``recompute(fn, *args)`` runs ``fn`` without keeping its activations and
runs it again in the backward, through ``torch.utils.checkpoint``
(non-reentrant, the RNG state preserved so a replayed dropout draws the
same mask): the ``remat="full"`` of the training rung.

``recompute(fn, *args, policy=checkpoint_policies.X)`` is selective
recompute (``remat="dots"``), built on
``torch.utils.checkpoint.create_selective_checkpoint_contexts``: the
policy sees every ATen op of the region's forward and says which
outputs to keep; the backward replays the region and takes the kept
outputs from the cache instead of running their ops again.
``checkpoint_policies.dots_with_no_batch_dims_saveable`` is the JAX
checkpoint policy of that name: it keeps the outputs of 2-D products
(``aten.mm``, ``aten.addmm``: a linear layer's ``x @ W`` over the
flattened tokens) and recomputes everything else, batched products
(``aten.bmm``: attention's score and value products) and the flash
kernel B10 among them, as the JAX policy recomputes ``pallas_call`` and
``dot_general`` with batch dimensions.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["recompute", "checkpoint_policies"]

#: the products with no batch dimension, whose outputs the ``dots``
#: policy keeps
_UNBATCHED_PRODUCTS = frozenset({torch.ops.aten.mm.default,
                                 torch.ops.aten.addmm.default})


def _dots_with_no_batch_dims_saveable(ctx, op, *args, **kwargs):
    """Keep the output of every 2-D product; recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _UNBATCHED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


#: the saveable policies ``recompute(policy=...)`` takes, by the names
#: the JAX callers use
checkpoint_policies = SimpleNamespace(
    dots_with_no_batch_dims_saveable=_dots_with_no_batch_dims_saveable)


def recompute(function, *args, preserve_rng_state: bool = True,
              use_reentrant: bool = True, policy=None, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    the backward; with ``policy`` (a ``checkpoint_policies`` entry, or
    any ``(ctx, op, *args, **kwargs) -> CheckpointPolicy`` function) the
    outputs it marks are kept and only the rest is recomputed.
    ``use_reentrant`` is accepted for Paddle's signature; the port
    always takes torch's non-reentrant form."""
    extra = {}
    if policy is not None:
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **extra,
                      **kwargs)

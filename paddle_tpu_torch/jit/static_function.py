"""``to_static``: one captured program per input signature (counterpart of
``paddle_tpu/jit/static_function.py``).

The JAX package traces the eager program once per input signature into
one compiled XLA executable and runs that on later calls; a gradient
comes from a second cached program, the vjp. The port keeps the same
cache, keyed exactly as the JAX package keys it (``_signature``: each
tensor argument's shape, dtype and whether it stops the gradient, the
layer's ``training``, the repr of the static arguments, the counts of
parameters and buffers, the grad mode), with the same ``jit.trace``
(a new program) and ``jit.cache_hit`` counters of ``profiler.stats``, so
the cache sizes and counts match the JAX package's over a call sequence.

A program's first call runs the function eagerly under
``graph_break.GraphBreakCheck``, which raises ``GraphBreakError`` at a
host read or a data-shaped operation, naming the function and the user's
line, before anything is captured. On the CPU every later call runs the
function eagerly too. On the card the program is then captured as CUDA
graphs, the counterpart of the compiled executable, which (unlike
``torch.compile``) also capture the ctypes-launched Hopper kernels:

- after one more warm-up run on the capture stream (cuDNN's and cuBLAS's
  workspaces and algorithm choices settle before the capture; the
  buffers and the generators are restored after it, so the warm-up
  changes no state), the forward is captured over static copies of the
  tensor arguments, the parameters and buffers read in place;
- where a gradient is wanted, the backward (``torch.autograd.grad`` of
  the differentiable outputs with respect to the differentiable
  arguments and parameters) is captured as a second graph in the same
  memory pool (the warm-up and the captures run the layer on new leaf
  tensors over the parameters' storage, so the graphs end at leaves of
  the capture stream), behind a ``torch.autograd.Function`` whose forward
  replays the first graph and whose backward replays the second, as the
  JAX package's vjp is a second cached program;
- a replay copies the arguments into the static inputs and copies the
  outputs (and gradients) out, since the next replay overwrites them;
- the saved activations live in the pool, one set a program: each
  forward replay is stamped, and a backward whose forward is no longer
  the last one replayed (the same program ran again before it, as for
  two views of a batch in one loss, or its own backward already ran)
  first replays its forward again from that call's own arguments,
  buffers and generator states, then puts the current buffers and
  generator states back, as the JAX package's vjp recomputes the
  forward from the operands bound to its node;
- BN running statistics are updated in place inside the graph (the JAX
  package returns them as outputs and rebinds them); dropout draws from
  the port's generators, registered with each graph, so every replay
  draws fresh masks (the JAX package threads a PRNG key operand);
- the graphs' memory pool lives as long as the program. A parameter or
  buffer whose storage moved since the capture (rebound, not copied
  into) makes the program capture itself again at its next call.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, List

import torch

from ..profiler import stats as _stats
from .graph_break import GraphBreakCheck

__all__ = ["StaticFunction", "to_static", "not_to_static"]


class _TensorIndex:
    """Placeholder marking a tensor leaf's position in a pytree."""

    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i

    def __repr__(self):
        # stable repr: it takes part in the program-cache signature
        return f"T{self.i}"


def _flatten_tensors(obj, out: List[torch.Tensor]):
    if torch.is_tensor(obj):
        out.append(obj)
        return _TensorIndex(len(out) - 1)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_flatten_tensors(v, out) for v in obj)
    if isinstance(obj, dict):
        return {k: _flatten_tensors(v, out) for k, v in obj.items()}
    return obj


def _unflatten_tensors(tmpl, tensors):
    if isinstance(tmpl, _TensorIndex):
        return tensors[tmpl.i]
    if isinstance(tmpl, (list, tuple)):
        return type(tmpl)(_unflatten_tensors(v, tensors) for v in tmpl)
    if isinstance(tmpl, dict):
        return {k: _unflatten_tensors(v, tensors) for k, v in tmpl.items()}
    return tmpl


def _differentiable(t) -> bool:
    return t.requires_grad and (t.is_floating_point() or t.is_complex())


def _on_card(tensors) -> bool:
    return any(t.is_cuda for t in tensors)


def _cuda_generators():
    from ..core import generator

    return [g for k, g in generator._GENERATORS.items()
            if k.startswith("cuda")]


def _graph(generators):
    """A new CUDA graph with the port's generators registered, where this
    torch can (drawing from an unregistered one during capture raises)."""
    g = torch.cuda.CUDAGraph()
    if hasattr(g, "register_generator_state"):
        for gen in generators:
            g.register_generator_state(gen)
    return g


@contextlib.contextmanager
def _leaf_aliases(sf):
    """Within the block, every parameter of ``sf``'s layer is replaced by
    a new leaf on the same storage; yields the aliases in ``sf._params``'
    order. A capture's autograd graph then ends at leaves made on the
    capture stream: a parameter's own accumulator node may still be alive
    from an eager call on another stream (a caller's last loss keeps its
    graph), and the backward's capture would have to wait on that
    stream."""
    made, saved, params = {}, [], sf._params
    mods = [] if sf._layer is None else list(sf._layer.modules())
    for mod in mods:
        for name, p in list(mod._parameters.items()):
            if p is None:
                continue
            if id(p) not in made:
                made[id(p)] = torch.nn.Parameter(
                    p.detach(), requires_grad=p.requires_grad)
            saved.append((mod, name, p))
            mod._parameters[name] = made[id(p)]
    try:
        yield [made[id(p)] for p in params]
    finally:
        for mod, name, p in saved:
            mod._parameters[name] = p


class _Graphs:
    """The captured forward (and backward) of one program on the card."""

    def __init__(self, prog: "_Program", arg_tensors, grad: bool):
        sf = prog.sf
        self.buffers = sf._buffers
        self.state = sf._params + self.buffers
        self.ptrs = [t.data_ptr() for t in self.state]
        self.static_args = [a.detach().clone().requires_grad_(
            a.requires_grad) for a in arg_tensors]
        self.tick = 0       # forward replays so far
        self.held = None    # the stamp whose activations the pool holds
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        self.gens = gens = _cuda_generators()
        saved = self.snapshot()
        with torch.cuda.stream(stream), _leaf_aliases(sf) as params:
            # warm-up on the capture stream; state restored after it
            outs = self._outputs(prog, self.static_args)
            diff = [o for o in outs if _differentiable(o)]
            if grad and diff:
                torch.autograd.grad(
                    diff, self._grad_inputs(params),
                    [torch.ones_like(o) for o in diff], allow_unused=True)
            del outs, diff
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        self.restore(saved)
        self.fwd = _graph(gens)
        self.bwd = None
        with _leaf_aliases(sf) as params:
            with torch.cuda.graph(self.fwd, stream=stream):
                self.outs = self._outputs(prog, self.static_args)
            self.diff_out = [i for i, o in enumerate(self.outs)
                             if _differentiable(o)]
            if grad and self.diff_out:
                self.grad_out = [torch.empty_like(self.outs[i])
                                 for i in self.diff_out]
                self.bwd = _graph(gens)
                with torch.cuda.graph(self.bwd, pool=self.fwd.pool(),
                                      stream=stream):
                    self.grads = torch.autograd.grad(
                        [self.outs[i] for i in self.diff_out],
                        self._grad_inputs(params), self.grad_out,
                        allow_unused=True)
                self.outs = [o.detach() for o in self.outs]
        torch.cuda.current_stream().wait_stream(stream)

    def _grad_inputs(self, params):
        return [a for a in self.static_args if _differentiable(a)] + \
            [p for p in params if _differentiable(p)]

    @staticmethod
    def _outputs(prog, args):
        out = prog.sf._call(prog.args_tmpl, prog.kwargs_tmpl, args)
        outs: List[torch.Tensor] = []
        prog.out_tmpl = _flatten_tensors(out, outs)
        return outs

    def stale(self) -> bool:
        return any(t.data_ptr() != p for t, p in zip(self.state, self.ptrs))

    def snapshot(self):
        """What a forward replay reads besides its arguments and the
        parameters, and may change: the buffers and generator states."""
        return ([b.detach().clone() for b in self.buffers],
                [g.get_state() for g in self.gens])

    def restore(self, snap) -> None:
        with torch.no_grad():
            for b, s in zip(self.buffers, snap[0]):
                b.copy_(s)
        for g, s in zip(self.gens, snap[1]):
            g.set_state(s)

    def load(self, arg_tensors):
        with torch.no_grad():
            for s, a in zip(self.static_args, arg_tensors):
                if s.data_ptr() != a.data_ptr():
                    s.copy_(a)

    def replay_forward(self, arg_tensors):
        """Replays the forward; its outputs, copied out, and its stamp."""
        self.load(arg_tensors)
        self.fwd.replay()
        self.tick += 1
        self.held = self.tick
        return [o.clone() for o in self.outs], self.tick

    def replay_backward(self, stamp, arg_tensors, before, grads):
        """The gradients of the forward stamped ``stamp`` (called on
        ``arg_tensors`` over the buffers and generator states ``before``)
        for the output gradients ``grads``: arguments' first, then the
        parameters', copied out."""
        if self.stale():
            raise RuntimeError(
                "to_static: a parameter or buffer was rebound between a "
                "call's forward and its backward; copy into it in place")
        if self.held != stamp:
            now = self.snapshot()
            self.restore(before)
            self.load(arg_tensors)
            self.fwd.replay()
            self.restore(now)
        with torch.no_grad():
            for i, buf in zip(self.diff_out, self.grad_out):
                if grads[i] is None:
                    buf.zero_()
                else:
                    buf.copy_(grads[i])
        self.bwd.replay()
        # the backward frees the saved activations into the pool
        self.held = None
        return [_clone(t) for t in self.grads]


class _Replay(torch.autograd.Function):
    """The captured forward and backward as one autograd node: inputs
    ``(graphs, args..., differentiable params...)``."""

    @staticmethod
    def forward(ctx, graphs, n_args, *inputs):
        ctx.graphs = graphs
        ctx.before = graphs.snapshot()
        outs, ctx.stamp = graphs.replay_forward(inputs[:n_args])
        ctx.save_for_backward(*inputs[:n_args])
        ctx.mark_non_differentiable(*[
            o for i, o in enumerate(outs) if i not in graphs.diff_out])
        return tuple(outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        g = ctx.graphs
        args = ctx.saved_tensors
        it = iter(g.replay_backward(ctx.stamp, args, ctx.before, grads))
        arg_grads = [next(it) if _differentiable(a) else None
                     for a in g.static_args]
        return (None, None, *arg_grads, *it)


def _clone(t):
    return None if t is None else t.clone()


class _Program:
    """One signature's program (the JAX package's ``_Program``)."""

    def __init__(self, sf: "StaticFunction", args_tmpl, kwargs_tmpl,
                 n_args: int):
        self.sf = sf
        self.args_tmpl = args_tmpl
        self.kwargs_tmpl = kwargs_tmpl
        self.n_args = n_args
        self.out_tmpl = None
        self.checked = False
        self.graphs = None

    def _grad_wanted(self, arg_tensors) -> bool:
        return torch.is_grad_enabled() and (
            any(_differentiable(p) for p in self.sf._params)
            or any(_differentiable(t) for t in arg_tensors))

    def run(self, arg_tensors: List[torch.Tensor]):
        sf = self.sf
        if not self.checked:
            with GraphBreakCheck(sf._name):
                out = sf._call(self.args_tmpl, self.kwargs_tmpl,
                               arg_tensors)
            self.checked = True
            return out
        if not _on_card(arg_tensors + sf._params + sf._buffers):
            return sf._call(self.args_tmpl, self.kwargs_tmpl, arg_tensors)
        grad = self._grad_wanted(arg_tensors)
        if self.graphs is None or self.graphs.stale():
            self.graphs = None
            self.graphs = _Graphs(self, arg_tensors, grad)
            _stats.inc("jit.capture")
        g = self.graphs
        if g.bwd is None:
            outs = g.replay_forward(arg_tensors)[0]
        else:
            params = [p for p in sf._params if _differentiable(p)]
            outs = list(_Replay.apply(g, len(arg_tensors), *arg_tensors,
                                      *params))
        return _unflatten_tensors(self.out_tmpl, outs)


class StaticFunction:
    """A function (or a layer's ``forward``) run through one captured
    program per input signature; eager while ``jit.enable_to_static``
    has it off (``_globally_enabled``)."""

    _globally_enabled = True

    def __init__(self, function: Callable, layer=None, input_spec=None,
                 build_strategy=None, backend=None, full_graph=True):
        self._orig_fn = function
        self._layer = layer if layer is not None else getattr(
            function, "__self__", None)
        self._input_spec = input_spec
        self._name = getattr(function, "__name__", "fn")
        self._programs: Dict[Any, _Program] = {}
        self._enabled = True
        functools.update_wrapper(self, function,
                                 assigned=("__name__", "__doc__"))

    @property
    def _params(self) -> List[torch.Tensor]:
        if self._layer is None:
            return []
        return [p for _, p in self._layer.named_parameters()]

    @property
    def _buffers(self) -> List[torch.Tensor]:
        if self._layer is None:
            return []
        return [b for _, b in self._layer.named_buffers()]

    def _call(self, args_tmpl, kwargs_tmpl, arg_tensors):
        args = _unflatten_tensors(args_tmpl, arg_tensors)
        kwargs = _unflatten_tensors(kwargs_tmpl, arg_tensors)
        return self._orig_fn(*args, **kwargs)

    def _signature(self, arg_tensors, args_tmpl, kwargs_tmpl):
        avals = tuple((tuple(t.shape), str(t.dtype), not t.requires_grad)
                      for t in arg_tensors)
        training = self._layer.training if self._layer is not None else None
        static_repr = repr((args_tmpl, kwargs_tmpl))
        n_state = (len(self._params), len(self._buffers))
        return (avals, training, static_repr, n_state,
                torch.is_grad_enabled())

    def __call__(self, *args, **kwargs):
        if not (self._enabled and StaticFunction._globally_enabled):
            return self._orig_fn(*args, **kwargs)
        arg_tensors: List[torch.Tensor] = []
        args_tmpl = _flatten_tensors(list(args), arg_tensors)
        kwargs_tmpl = _flatten_tensors(dict(kwargs), arg_tensors)
        sig = self._signature(arg_tensors, args_tmpl, kwargs_tmpl)
        prog = self._programs.get(sig)
        if prog is None:
            _stats.inc("jit.trace")
            prog = _Program(self, args_tmpl, kwargs_tmpl, len(arg_tensors))
            self._programs[sig] = prog
        else:
            _stats.inc("jit.cache_hit")
        return prog.run(arg_tensors)

    @property
    def program_cache(self):
        return self._programs

    def rollback(self):
        """Restore the original eager function."""
        self._enabled = False
        if self._layer is not None:
            self._layer.forward = self._orig_fn
        return self._orig_fn


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=True, **kwargs):
    """A plain function, a layer's method, or a layer (its ``forward``
    wrapped in place) run through ``StaticFunction``; a decorator or a
    call."""
    from ..nn import Layer

    def wrap(fn):
        if isinstance(fn, Layer):
            layer = fn
            layer.forward = StaticFunction(
                layer.forward, layer=layer, input_spec=input_spec,
                build_strategy=build_strategy)
            return layer
        if isinstance(fn, StaticFunction):
            return fn
        return StaticFunction(fn, input_spec=input_spec,
                              build_strategy=build_strategy)

    if function is not None:
        return wrap(function)
    return wrap


def not_to_static(fn):
    fn._not_to_static = True
    return fn

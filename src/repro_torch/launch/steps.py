"""Step builders: train, prefill and decode (the port of
``repro/launch/steps.py``), and the port of the reference's ``jax.jit``
around them.

The train step (:func:`make_train_step`) runs through autograd: the loss,
its gradients, then the optimizer update written in place into the
parameters and the optimizer state under ``torch.no_grad()`` (the
counterpart of the reference's donated buffers; AdamW is one hand-written
kernel on the card, ``kernels/adamw``).

The reference traces each step once per input signature and replays the
XLA program after that. Here, on a CUDA device, a step is captured once
per signature as a CUDA graph and replayed after that
(:class:`CompiledStep`): the signature is the arguments' tree, shapes and
dtypes (as ``jax.jit``'s cache key), which axes are broadcast (stride 0),
the Python constants among them, and the params tree by address (the
graph reads the weights where they lie; another params tree of the same
shapes captures another graph). A train step holds every operand by
address (params, optimizer state and batch: it writes the first two in
place, and the caller writes each batch into the same tensors), copies
none, and applies one update a call: its first call of a signature is
the eager warm-up, whose update is that call's, and the capture records
without running. Every hand-written kernel of the step runs inside the
graph, as it runs eagerly.

On the CPU the steps run eagerly (the test path). ``compiled=False`` runs
them eagerly on the card too: the eager side of a comparison.

``policy=`` installs a :class:`~repro_torch.core.program.PipePolicy` as
the session policy around the step body, tagged with the ambient mesh
(``runtime.streams.mesh_policy``), as the reference's ``_policy_scope``
does: every kernel of the step sizes its pipes by it, its plans keyed by
the topology.

Under a mesh (``runtime.sharding.use_sharding``) the train step takes
DTensor parameters, optimizer state and batch, placed by the logical rules
(:func:`shardings_for_cell`). The model runs under DTensor's
``implicit_replication`` (a tensor the model makes, a mask or a position
range, counts as replicated), and each gradient is redistributed to its
parameter's placements before the update: for a parameter replicated over
"data" that is the data-parallel all-reduce. A
compiled step resolves its plans when it captures (nothing is measured
inside a capture: ``autotune.capture_scope``), so its graphs are keyed by
the session policy and the plan generation too
(``autotune.plans_generation``): a step run under another policy, or
after the plan caches were cleared or redirected, captures anew instead
of replaying plans resolved under the old ones.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import autotune
from repro_torch.core.program import current_policy
from repro_torch.core.program import policy as policy_ctx
from repro_torch.kernels import launch_counters
from repro_torch.models import layers as L
from repro_torch.optim import adafactor, adamw
from repro_torch.optim.compression import QuantizedAccumulator
from repro_torch.runtime import sharding as shlib


def _policy_scope(policy):
    """The session-policy context of one step body, the policy tagged with
    the ambient mesh (no-op without a policy)."""
    if policy is None:
        return contextlib.nullcontext()
    from repro_torch.runtime.streams import mesh_policy
    return policy_ctx(mesh_policy(policy))


def _sharded_scope(params):
    """``implicit_replication`` when the parameters are DTensors (plain
    tensors the model makes then count as replicated), else nothing."""
    if not any(shlib.is_dtensor(p) for _, p in L.tree_leaves(params)):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def reduce_grads(grads, params):
    """Each DTensor gradient redistributed to its parameter's placements
    (a partial sum over "data" becomes its all-reduce; over a sharded
    "model" dim, its reduce-scatter); plain gradients as they are.

    ``grads`` is consumed: each leaf leaves it as it is reduced, smallest
    first, so a full-size partial sum is freed once its shard exists and
    the largest leaf's collective (several times its size in transient
    buffers) runs when the others are already reduced. At full-width
    llama3.2-1b on (data 2, model 2) a rank's peak falls from 16.13 to
    13.52 GiB (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase j's
    ``dist`` line). Every rank takes the leaves in the same order."""
    p_leaves = dict(L.tree_leaves(params))
    sizes = {path: g.numel() for path, g in L.tree_leaves(grads)}
    out: Dict = {}
    for path in sorted(sizes, key=sizes.__getitem__):
        node = grads
        for k in path[:-1]:
            node = node[k]
        g = node.pop(path[-1])
        p = p_leaves[path]
        if shlib.is_dtensor(g):
            g = g.redistribute(p.device_mesh, p.placements)
        L._put(out, path, g)
    return out


def opt_init_and_update(optimizer: str, opt_cfg=None):
    """(init(params) -> state, update(grads, state, params) -> (params,
    state, metrics)) of "adamw" (the default) or "adafactor"."""
    if optimizer == "adafactor":
        cfg = opt_cfg or adafactor.AdafactorConfig()
        return (adafactor.init,
                lambda g, s, p: adafactor.update(cfg, g, s, p))
    cfg = opt_cfg or adamw.AdamWConfig()
    return adamw.init, lambda g, s, p: adamw.update(cfg, g, s, p)


def opt_state_axes(optimizer: str, param_axes):
    """Logical axes of the optimizer state (they mirror the params')."""
    if optimizer == "adafactor":
        def st(ax):
            if len(ax) >= 2:
                return {"vr": tuple(ax[:-1]),
                        "vc": tuple(ax[:-2]) + (ax[-1],)}
            return {"v": tuple(ax)}
        return {"v": L.tree_map(st, param_axes), "step": ()}
    return {"m": param_axes, "v": param_axes, "step": ()}


def init_params(model, gen: torch.Generator, device):
    """``model.init(gen, device)``, placed under the ambient mesh: each
    leaf is drawn whole (the same bits on every rank, in ``model.init``'s
    order) and replaced at once by this rank's shard, so one full leaf at
    most is held. Without a mesh context it is ``model.init``."""
    ctx = shlib.current()
    if ctx is None:
        return model.init(gen, device)
    out: Dict = {}
    for path, spec in L.tree_leaves(model.param_specs()):
        L._put(out, path, shlib.sharding_for(spec.axes, ctx, spec.shape)
               .place(spec.initializer(gen, device)))
    return out


def value_and_grad(model, params, batch):
    """(the loss's metrics, detached; the gradient of ``model.loss`` with
    respect to every leaf of ``params``, in the params' tree). Marks every
    leaf ``requires_grad``. A leaf the loss does not read (the VLM's
    projection without patch embeddings) gets zeros, as ``jax.grad``
    gives it."""
    leaves = [leaf for _, leaf in L.tree_leaves(params)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    out: Dict = {}
    for (path, p), g in zip(L.tree_leaves(params), grads):
        L._put(out, path, torch.zeros_like(p) if g is None else g)
    return {k: v.detach() for k, v in metrics.items()}, out


def make_train_step(model, *, optimizer: str = "adamw", opt_cfg=None,
                    accum_steps: int = 1, quantized_accum: bool = False,
                    compiled: bool = True, policy=None):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): the loss's gradients with respect to every parameter leaf,
    then one optimizer update, written in place (the returned trees are
    the ones passed in). Metrics: the loss's (``loss``, and ``aux`` where
    the model reports it) and the optimizer's (``grad_norm`` and ``lr``
    for AdamW, ``lr`` for Adafactor), as 0-d tensors.

    On a CUDA device the step is captured as a CUDA graph per signature
    and replayed (:class:`CompiledStep` with ``in_place``): pass the same
    params, optimizer state and batch tensors every call (write each
    batch into them); new addresses capture a new graph. Its metrics are
    the graph's buffers, overwritten by the next call. ``compiled=False``
    runs it eagerly; CPU steps always do. DTensor operands (a mesh) need
    ``compiled=False``.

    With ``accum_steps`` > 1 the batch splits into microbatches along dim
    0 and their gradients are summed in f32 (or in int8 with error
    feedback, ``quantized_accum``) before one update with their mean; the
    loss metrics are the microbatches' means. ``policy`` is the session
    :class:`~repro_torch.core.program.PipePolicy` around the step body.
    With DTensor parameters the gradients are reduced to the parameters'
    placements before the update (:func:`reduce_grads`) and the metrics
    come back as plain tensors, the same on every rank."""
    _, opt_update = opt_init_and_update(optimizer, opt_cfg)

    def step(params, opt_state, batch):
        if accum_steps == 1:
            metrics, grads = value_and_grad(model, params, batch)
        else:
            if quantized_accum:
                acc = QuantizedAccumulator.init(params)
            else:
                acc = L.tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params)
            per_micro = []
            for i in range(accum_steps):
                mb = {k: v.chunk(accum_steps, dim=0)[i]
                      for k, v in batch.items()}
                m, g = value_and_grad(model, params, mb)
                per_micro.append(m)
                if quantized_accum:
                    acc = QuantizedAccumulator.add(acc, g)
                else:
                    g_leaves = dict(L.tree_leaves(g))
                    for path, a in L.tree_leaves(acc):
                        a.add_(g_leaves[path].float())
            if quantized_accum:
                acc = QuantizedAccumulator.read(acc)
            grads = L.tree_map(lambda a: a / accum_steps, acc)
            metrics = {k: torch.mean(torch.stack([m[k] for m in per_micro]))
                       for k in per_micro[0]}
        grads = reduce_grads(grads, params)
        params, opt_state, opt_metrics = opt_update(grads, opt_state, params)
        return params, opt_state, {**metrics, **opt_metrics}

    def train_step(params, opt_state, batch):
        with _sharded_scope(params):
            params, opt_state, metrics = step(params, opt_state, batch)
        return params, opt_state, {k: shlib.full_tensor(v)
                                   for k, v in metrics.items()}
    if compiled:
        train_step = CompiledStep(train_step, in_place=True)
    return train_step if policy is None else _PolicyStep(train_step, policy)


def make_prefill_step(model, *, compiled: bool = True, policy=None):
    """prefill_step(params, batch) -> (last-token logits [B, V], cache)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        with _sharded_scope(params):
            return model.prefill(params, batch)
    step = _compiled(model, "prefill", prefill_step) if compiled \
        else prefill_step
    return step if policy is None else _PolicyStep(step, policy)


def make_decode_step(model, *, compiled: bool = True, policy=None):
    """decode_step(params, batch, cache) -> (greedy next token [B] int32,
    logits [B, V], cache). ``argmax`` takes the first index on ties, as
    ``jnp.argmax`` does."""
    @torch.no_grad()
    def decode_step(params, batch, cache):
        with _sharded_scope(params):
            logits, new_cache = model.decode_step(params, batch, cache)
            return _greedy(logits), logits, new_cache
    step = _compiled(model, "decode", decode_step) if compiled \
        else decode_step
    return step if policy is None else _PolicyStep(step, policy)


def _greedy(logits) -> torch.Tensor:
    """The greedy token of each row of ``logits`` [B, V], int32. A DTensor
    takes its argmax in a local body over whole rows (a vocab sharded
    over "model" is gathered first), its batch shards kept."""
    if not shlib.is_dtensor(logits):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    from torch.distributed.tensor.experimental import local_map
    pl = shlib.kept(logits.placements, (0,))
    body = local_map(lambda t: torch.argmax(t, dim=-1).to(torch.int32),
                     out_placements=pl, in_placements=(pl,),
                     device_mesh=logits.device_mesh,
                     redistribute_inputs=True)
    return body(logits)


class _PolicyStep:
    """A step run under ``policy`` (the session policy around each
    call)."""

    def __init__(self, step, policy):
        self.step = step
        self.policy = policy

    def __call__(self, *args):
        with _policy_scope(self.policy):
            return self.step(*args)


def _compiled(model, kind: str, fn) -> "CompiledStep":
    """One compiled step of each kind a model: every ``make_*_step`` call
    shares its graphs, as a jitted function shares its traces."""
    steps = model.__dict__.setdefault("_compiled_steps", {})
    if kind not in steps:
        steps[kind] = CompiledStep(fn)
    return steps[kind]


# ---------------------------------------------------------------------------
# pytrees of tensors
# ---------------------------------------------------------------------------


def _flatten(tree, leaves: List[torch.Tensor]):
    """The hashable spec of ``tree`` (dicts, lists, tuples of tensors and
    constants), appending its tensors to ``leaves`` in spec order."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _flatten(tree[k], leaves))
                              for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,
                tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("tensor", tuple(tree.shape), tree.dtype,
                tuple(s == 0 and n > 1
                      for s, n in zip(tree.stride(), tree.shape)))
    return ("const", tree)


def _unflatten(spec, leaves):
    """The tree of ``spec`` with the tensors taken from iterator
    ``leaves``, in fresh containers."""
    kind, body = spec[0], spec[1]
    if kind == "dict":
        return {k: _unflatten(v, leaves) for k, v in body}
    if kind in ("list", "tuple"):
        items = [_unflatten(v, leaves) for v in body]
        return items if kind == "list" else tuple(items)
    if kind == "tensor":
        return next(leaves)
    return body


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` without its broadcast (stride 0) axes: the memory it views."""
    for axis, (s, n) in enumerate(zip(t.stride(), t.shape)):
        if s == 0 and n > 1:
            t = t.narrow(axis, 0, 1)
    return t


def _same_buffer(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.device == b.device and a.data_ptr() == b.data_ptr()
            and a.stride() == b.stride())


def _load(statics, leaves) -> int:
    """Copy each input into its static buffer unless it is that buffer (a
    cache the step returned); returns the copies made."""
    copies = 0
    for src, dst in zip(leaves, statics):
        if not _same_buffer(src, dst):
            _dense(dst).copy_(_dense(src), non_blocking=True)
            copies += 1
    return copies


# ---------------------------------------------------------------------------
# the compiled step
# ---------------------------------------------------------------------------


class _Graph:
    """One captured signature: its static inputs, its replay, its outputs,
    what its capture counted in each kernel wrapper's ``launches``, and
    the result of its eager warm-up (``first``)."""

    def __init__(self, statics, replay: Callable[[], None], out, launches,
                 first):
        self.statics = statics
        self.replay = replay
        self.out_leaves: List[torch.Tensor] = []
        self.out_spec = _flatten(out, self.out_leaves)
        self.launches = launches
        self.first = first

    def run(self):
        self.replay()
        for wrapper, n in self.launches:
            wrapper.launches += n
        return _unflatten(self.out_spec, iter(self.out_leaves))


_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
_POOLS: Dict[torch.device, tuple] = {}


def _cuda_capture(run: Callable[[], object],
                  reload: Optional[Callable[[], None]],
                  device: torch.device):
    """Warm ``run`` up once eagerly on the capture stream, ``reload`` the
    static inputs it wrote, then capture it as a CUDA graph on that stream
    in the pool every graph of the device shares. Returns (replay,
    outputs, launches the capture counted). ``reload`` None: the step
    writes its operands in place (a train step), and the warm-up's result
    is its call's (the capture runs nothing, so the call applies one
    update).

    The warm-up builds and loads the kernels, runs their one-time
    attribute set-up (``cudaFuncSetAttribute``) and sizes their scratch
    buffers (``ff_decode_attention.ops._scratch``,
    ``ff_layer.ops._tickets``, kept per stream) on this stream, where the
    capture finds them: a capture that would allocate one raises. It also
    gives cuBLAS its workspace for the stream. Kernels that take a TMA
    tensor map by value (``ff_attention``, ``ff_attention_proj``,
    ``ff_matmul``) build it on the host at the launch; the captured node
    keeps that map, which is right because the graph's buffers (static
    inputs, weights, its pool) never move. The cyclic garbage collector
    is off during the capture: a model holds its compiled steps, whose
    functions hold the model, so a dropped model's graphs are freed by
    the collector, and a graph freed while another is being captured
    invalidates that capture. A failed capture raises: there is no eager
    fallback."""
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
        _POOLS[device] = torch.cuda.graph_pool_handle()
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        run()
    current.wait_stream(stream)
    if reload is not None:
        reload()              # the warm-up wrote the cache in place
    counters = launch_counters()
    before = [w.launches for w in counters]
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=_POOLS[device], stream=stream):
            out = run()
    finally:
        if collecting:
            gc.enable()
        # the capture launched nothing: its counts go to each replay
        delta = [(w, w.launches - n) for w, n in zip(counters, before)]
        for w, n in zip(counters, before):
            w.launches = n
    return graph.replay, out, [(w, n) for w, n in delta if n]


class CompiledStep:
    """``fn(params, *args)`` captured once per signature and replayed
    after that, on the devices named in ``devices`` (CUDA); elsewhere it
    runs eagerly.

    Each signature keeps its own static input buffers; an input is copied
    into its buffer before a replay unless it is that buffer, so a caller
    that hands back the cache the step returned copies nothing (the
    counterpart of the reference's buffer donation). The outputs are the
    graph's own buffers, outside the pool the graphs share: the next call
    of the same signature overwrites them (clone what you keep), and no
    other graph's replay does. Caches the step updates in place are its
    static inputs: use the returned cache, not the one passed in.

    ``in_place`` (a train step): every operand is held by address like
    the params (keyed by it, read where it lies, never copied: no static
    buffers), outputs that are operands come back as themselves, and the
    first call of a signature returns its eager warm-up's result, so N
    calls apply N updates. ``capture`` is :func:`_cuda_capture`, or a
    stand-in with its signature (the CPU tests' bookkeeping)."""

    def __init__(self, fn, *, capture=_cuda_capture,
                 devices: Tuple[str, ...] = ("cuda",),
                 in_place: bool = False):
        self.fn = fn
        self.capture = capture
        self.devices = devices
        self.in_place = in_place
        self.graphs: Dict[tuple, _Graph] = {}
        self.last_copies = 0

    def __call__(self, params, *args):
        p_leaves: List[torch.Tensor] = []
        p_spec = _flatten(params, p_leaves)
        leaves: List[torch.Tensor] = []
        spec = _flatten(args, leaves)
        if any(shlib.is_dtensor(t) for t in (*p_leaves, *leaves)):
            raise NotImplementedError(
                "a compiled (CUDA-graph) step under a mesh is not ported: "
                "its capture would hold collectives; build the step with "
                "compiled=False for DTensor operands")
        device = p_leaves[0].device
        if device.type not in self.devices:
            return self.fn(params, *args)
        held = p_leaves + leaves if self.in_place else p_leaves
        # the graph holds the plans resolved at its capture: key it by
        # what they were resolved under, as well as by its inputs
        key = (p_spec, tuple(t.data_ptr() for t in held), spec,
               current_policy(), autotune.plans_generation())
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = self._capture(params, spec, leaves,
                                                     held, device)
            if self.in_place:
                self.last_copies = 0
                return graph.first
        self.last_copies = _load(graph.statics, leaves)
        return graph.run()

    def _capture(self, params, spec, leaves, held, device) -> _Graph:
        if self.in_place:
            statics: List[torch.Tensor] = []
            args = _unflatten(spec, iter(leaves))
        else:
            statics = [torch.empty_strided(t.shape, t.stride(),
                                           dtype=t.dtype, device=device)
                       for t in leaves]
            args = _unflatten(spec, iter(statics))
            _load(statics, leaves)
        inputs = {t.untyped_storage().data_ptr() for t in statics + held}
        holders: List = []
        results: List = []

        def run():
            """The step on the static inputs, each output that is not one
            of them copied into a buffer of its own, made at the first
            (eager) run: the graphs share one pool, where a graph
            captured later may place its outputs in an earlier one's
            intermediates, so an output left there would be overwritten
            by that graph's next replay."""
            out = self.fn(params, *args)
            outs: List[torch.Tensor] = []
            out_spec = _flatten(out, outs)
            if not holders:
                holders.extend(
                    None if t.untyped_storage().data_ptr() in inputs
                    else torch.empty_like(t) for t in outs)
            for h, t in zip(holders, outs):
                if h is not None:
                    h.copy_(t)
            result = _unflatten(out_spec, iter(
                t if h is None else h for h, t in zip(holders, outs)))
            if not results:
                results.append(result)      # the warm-up's
            return result

        # the warm-up and the capture resolve every kernel's plan; nothing
        # may be measured in them (no candidate launch, no synchronize
        # while the stream captures)
        with autotune.capture_scope():
            replay, out, launches = self.capture(
                run, None if self.in_place else
                (lambda: _load(statics, leaves)), device)
        return _Graph(statics, replay, out, launches, results[0])


# ---------------------------------------------------------------------------
# Shardings of the step entry points
# ---------------------------------------------------------------------------


def shardings_for_cell(model, shape, ctx, *, optimizer: str = "adamw"):
    """The NamedShardings (``runtime.sharding``) of each step input for
    the mesh context ``ctx``: {"params", "batch"} and, for a train shape,
    "opt", for a decode shape, "cache"."""
    sh = lambda axes_tree: shlib.tree_shardings(axes_tree, ctx)   # noqa: E731
    p_axes = model.param_axes()
    out = {"params": sh(p_axes), "batch": sh(model.input_axes(shape))}
    if shape.kind == "train":
        out["opt"] = sh(opt_state_axes(optimizer, p_axes))
    if shape.kind == "decode":
        _, cache_axes = model.cache_spec(shape)
        out["cache"] = sh(cache_axes)
    return out

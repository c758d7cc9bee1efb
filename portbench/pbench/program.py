"""Every call the harness makes into the program (``repro_torch``): the
model built from a configuration file, the set-up that captures the
window's CUDA graphs, and the window itself, one call of the paged
continuous-batching scheduler ``launch/serve.py:run_continuous``.

Set-up replays, ahead of the window, what ``run_continuous`` does first
in every call: one prefill a prompt bucket, one admission scatter and one
decode step at the window's signature (slots, pool blocks, pages a row).
On the card each is captured once as a CUDA graph, so the window's call
only replays. The scheduler sizes its block tables by the longest request
of its trace, and every window of a traffic file holds the longest
request the file allows (``pbench.traffic``), so set-up knows the
signature before it knows the window. A graph captured inside the window
is an error (:func:`graph_count` before and after).
"""

from __future__ import annotations

import gc
from typing import Dict, Iterable, List

import numpy as np
import torch

from pbench.model import Model
from pbench.traffic import Req
from pbench.weights import flat


def build(m: Model):
    """(the port's ArchConfig, its model) for the sizes of ``m``."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    cfg = m.port_config(get_config(m.port_arch))
    return cfg, build_model(cfg)


def check_tree(model, params) -> None:
    """The harness's tree has the leaves, shapes and served types the
    model takes: every leaf in ``cfg.cdtype`` but those the model reads
    in float32 (``F32_LEAVES``)."""
    want = dict(flat(model.abstract_params()))
    got = dict(flat(params))
    if set(want) != set(got):
        raise ValueError(f"weight tree differs from the model's: missing "
                         f"{sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}")
    f32 = type(model).F32_LEAVES
    for path, t in got.items():
        dt = (torch.float32 if any(path[:len(p)] == p for p in f32)
              else model.cfg.cdtype)
        if tuple(t.shape) != tuple(want[path].shape) or t.dtype != dt:
            raise ValueError(f"leaf {path}: {tuple(t.shape)} {t.dtype}, "
                             f"the model takes {tuple(want[path].shape)} "
                             f"{dt}")


def _ints(x, device) -> torch.Tensor:
    from repro_torch.runtime.paged_kv import to_device
    return to_device(np.asarray(x, np.int32), device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Server:
    """The model, its weights and the window's signature."""

    def __init__(self, cfg, model, params, *, slots: int, page: int,
                 pool_blocks: int, pages_max: int):
        self.cfg, self.model, self.params = cfg, model, params
        self.slots, self.page = slots, page
        self.pool_blocks, self.pages_max = pool_blocks, pages_max
        self.device = params["embed"].device

    def _steps(self):
        from repro_torch.launch import steps
        return (steps.make_prefill_step(self.model, compiled=True),
                steps.make_decode_step(self.model, compiled=True))

    def _cache(self):
        from repro_torch.runtime.paged_kv import PagedKVCache
        c = self.cfg
        return PagedKVCache(
            n_layers=c.n_layers, n_blocks=self.pool_blocks, page=self.page,
            kv_heads=c.n_kv_heads, head_dim=c.hd, n_slots=self.slots,
            n_pages_max=self.pages_max, dtype=c.cdtype, device=self.device)

    def warm(self, buckets: Iterable[int]) -> None:
        """Capture (on the card) each prefill bucket, admitting it into a
        throw-away pool as the scheduler does, and one decode step at the
        window's signature."""
        prefill, dstep = self._steps()
        pool = self._cache()
        for i, b in enumerate(sorted(set(buckets))):
            tokens = {"tokens": _ints(np.zeros((1, b)), self.device)}
            _, wc = prefill(self.params, tokens)
            pool.admit(i % self.slots, wc["k"][:, 0], wc["v"][:, 0], 4, 4)
            pool.retire(i % self.slots)
        zeros = _ints(np.zeros(self.slots), self.device)
        dstep(self.params, {"token": zeros, "lengths": zeros},
              pool.cache_view())
        _sync(self.device)
        del pool
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def graph_count(self) -> int:
        steps = self.model.__dict__.get("_compiled_steps", {})
        return sum(len(s.graphs) for s in steps.values())

    def serve(self, reqs: List[Req]) -> Dict:
        """The window: one ``run_continuous`` call over ``reqs``, all
        present at its start, greedy, no end-of-sequence token."""
        from repro_torch.launch.serve import Request, run_continuous
        trace = [Request(r.rid, 0.0, r.prompt, r.max_new) for r in reqs]
        return run_continuous(self.model, self.params, self.cfg, trace,
                              n_slots=self.slots, page=self.page,
                              eos_id=None, pool_blocks=self.pool_blocks)

    def release(self) -> None:
        """Drop the program's state (captured graphs and their buffers)
        before the reference runs."""
        self.model.__dict__.pop("_compiled_steps", None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

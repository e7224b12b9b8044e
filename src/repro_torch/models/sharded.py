"""A model's side of an active training mesh, shared by ``LM`` and
``EncDec``: the rule table's specs of its parameters, the active mesh of
more than one rank, a stack of blocks each of which gathers its weights
before use (again in the backward's recompute under remat), and the
mean loss over the masked count of every rank.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import (axis_rules, current_mesh,
                                        current_rules, param_sharding_tree,
                                        shard_index)


def _gathered(i: int, params: dict, spec: dict, mesh) -> dict:
    """A block's weights with every sharded leaf gathered whole."""
    return C.gather_tree(params, spec, mesh)


class MeshModel:
    """Mixed into a model that has ``logical()``, ``parallel``, a
    ``_specs`` dict and ``_cache_seq`` (the positions of the dense cache
    ``init_cache`` made last under a mesh; None before)."""

    def param_specs(self, mesh) -> dict:
        """``param_sharding_tree`` of ``logical()`` on ``mesh`` (cached
        per mesh shape)."""
        key = (mesh.axis_names, tuple(mesh.shape.values()))
        if key not in self._specs:
            self._specs[key] = param_sharding_tree(self.logical(), mesh)
        return self._specs[key]

    def _mesh(self):
        """The active training mesh of more than one rank, or None."""
        mesh = current_mesh()
        return None if mesh is None or mesh.world == 1 else mesh

    def _offset(self, mesh, s: int) -> int:
        """The global index of this rank's first row of a sequence it
        holds ``s`` rows of."""
        return mesh.coords.get("model", 0) * s if mesh is not None else 0

    def _decode_rows(self, mesh, batch: int) -> tuple:
        """(first row, rows) of this rank's slice of a dense decode batch
        of ``batch`` rows under ``mesh``: the rule table's ``batch`` over
        every axis but the model axis, or -- where dp does not divide the
        batch, as ``param_sharding_tree`` keeps such a dim whole -- every
        row on every data rank, ``(0, batch)``.  Decode sums nothing over
        the data axes, so rows held whole by every data rank are decoded
        alike on each and counted nowhere twice."""
        d, dp = shard_index(tuple(a for a in mesh.axis_names
                                  if a != "model"), mesh, mesh.coords)
        if batch % dp:
            return 0, batch
        return d * (batch // dp), batch // dp

    def _kv_split(self, mesh) -> bool:
        """Whether the model axis splits the dense KV caches' positions
        (``kv_seq -> model``) of the cache ``init_cache`` made last under
        a mesh: not where it does not divide their width -- every model
        rank then holds them whole and decodes them as one device does,
        with no merge."""
        n = mesh.shape.get("model", 1)
        return n > 1 and (self._cache_seq is None
                          or self._cache_seq % n == 0)

    def _whole(self, params: dict, keys: tuple) -> dict:
        """``params`` with those of its top-level subtrees named in
        ``keys`` gathered whole under a mesh (the blocks gather theirs in
        ``_run_blocks``)."""
        mesh = self._mesh()
        if mesh is None:
            return params
        specs = self.param_specs(mesh)
        return {k: C.gather_tree(v, specs[k], mesh) if k in keys else v
                for k, v in params.items()}

    def _run_blocks(self, params: dict, key: str, fn: Callable,
                    x: torch.Tensor, *extra,
                    leaves: Optional[Callable] = None) -> torch.Tensor:
        """x through ``fn(i, block_params, x, *extra)`` for each block i
        of the list ``params[key]``, each recomputed in the backward under
        remat.  Under a mesh a block runs on ``leaves(i, params, spec,
        mesh)`` (by default every sharded leaf gathered whole; ``spec``:
        the block's in ``param_specs``), taken inside the block so that
        the recompute gathers again."""
        mesh = self._mesh()
        specs = self.param_specs(mesh)[key] if mesh is not None else None
        leaves = leaves or _gathered
        remat = self.parallel.remat != "none" and torch.is_grad_enabled()
        for i, p in enumerate(params[key]):
            def run(h, *e, i=i, p=p):
                if mesh is None:
                    return fn(i, p, h, *e)
                # entered here again: the backward's recompute may run on
                # autograd's device thread, which has no context of ours
                with axis_rules(current_rules(), mesh):
                    return fn(i, leaves(i, p, specs[i], mesh), h, *e)
            x = checkpoint(run, x, *extra, use_reentrant=False) if remat \
                else run(x, *extra)
        return x

    def _mean_nll(self, logits: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross entropy; labels < 0 are masked.  Under a
        mesh: this rank's share of the global batch's mean -- its summed
        nll over the masked count of every rank -- so that the ranks'
        shares (and their gradients) sum to the mean."""
        logits = logits.float()
        mask = labels >= 0
        lab = torch.clamp(labels, min=0).long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        count = mask.sum()
        mesh = self._mesh()
        if mesh is not None:
            C.all_reduce(count, mesh.group(mesh.axis_names))
        return ((logz - gold) * mask).sum() / torch.clamp(count, min=1)

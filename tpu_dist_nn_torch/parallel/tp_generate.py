"""Tensor-parallel autoregressive generation: the Megatron-sharded decode.

Port of :mod:`tpu_dist_nn.parallel.tp_generate`. Decoding runs over the
model slots of each data replica: model slot ``m`` holds heads ``[m H/N,
(m+1) H/N)`` of every block (the training layout of
:func:`~tpu_dist_nn_torch.parallel.tensor_parallel.tp_shard_blocks`, so a
tensor-parallel model decodes without resharding) and its slice of the KV
cache, ``(L, B, max_len, H/N, Dh)``. A shard's work runs on its slot's
stream; per block and token the two partial sums meet in
:func:`~tpu_dist_nn_torch.parallel.collectives.psum` on the lead slot,
where the residual stream, the head and the sampler live. The logits are
replicated by construction (one fixed-order sum), so the one sampled
token is every slot's.

Numerics follow the single program (:mod:`~tpu_dist_nn_torch.models.
generate`): the prompt through materialised attention, every cached
attention through ``_attend_cache``'s cast order. Greedy tokens equal the
single program's wherever no near-tie meets the psum's reordered sums;
sampling reads the single program's noise from the caller's generator
(:func:`~tpu_dist_nn_torch.parallel.pp_generate.draw_noise`), and data
shards take their rows of it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_dist_nn_torch.models.generate import _attend_cache, _sample, validate_generate_args
from tpu_dist_nn_torch.models.transformer import dot_product_attention, layer_norm
from tpu_dist_nn_torch.parallel.collectives import on_slot
from tpu_dist_nn_torch.parallel.gpipe import caller_event, gather, launch
from tpu_dist_nn_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL, Mesh
from tpu_dist_nn_torch.parallel.pp_generate import draw_noise
from tpu_dist_nn_torch.parallel.tensor_parallel import shard_views, tp_block_apply


class _Shards:
    """One data replica's decode state over its model slots."""

    def __init__(self, cfg, cell, shards: list, top: dict, max_len: int):
        self.cfg, self.cell, self.top, self.max_len = cfg, cell, top, max_len
        self.n = len(cell)
        self.layers = [[{k: v[i] for k, v in sh.items()} for i in range(cfg.n_layers)]
                       for sh in shards]
        self.cache = [None] * self.n

    def _block(self, i, x, attn):
        """Layer ``i`` on replicated ``x``; ``attn(m, q, k, v)`` is shard
        ``m``'s attention."""
        return tp_block_apply([layers[i] for layers in self.layers], x, self.cfg, self.cell,
                              shard_attn=attn)

    def logits(self, x):
        h = layer_norm(x, self.top["lnf_g"], self.top["lnf_b"])
        return h @ self.top["tok_embed"].T

    def prefill(self, prompt):
        """The prompt ``(B, T)`` through every layer, filling each shard's
        cache; returns the logits ``(B, T, V)``."""
        cfg = self.cfg
        B, T = prompt.shape
        x = self.top["tok_embed"][prompt] + self.top["pos_embed"][:T]
        ks = [[] for _ in range(self.n)]
        vs = [[] for _ in range(self.n)]

        def attn(m, q, k, v):
            ks[m].append(k)
            vs[m].append(v)
            return dot_product_attention(q, k, v, causal=True)

        for i in range(cfg.n_layers):
            x = self._block(i, x, attn)
        pad = (0, 0, 0, 0, 0, self.max_len - T)
        for m, slot in enumerate(self.cell):
            with on_slot(slot):
                self.cache[m] = {"k": F.pad(torch.stack(ks[m]), pad),
                                 "v": F.pad(torch.stack(vs[m]), pad)}
        return self.logits(x)

    def decode(self, token, pos):
        """One token ``(B,)`` at position ``pos`` (a ``(1,)`` device index)
        through every layer; returns its logits ``(B, V)``."""
        x = self.top["tok_embed"][token][:, None, :] + self.top["pos_embed"].index_select(0, pos)[None]
        live = {}
        layer = {"i": 0}

        def attn(m, q, k, v):
            i, c = layer["i"], self.cache[m]
            pm = pos.to(q.device)
            c["k"][i].index_copy_(1, pm, k.to(c["k"].dtype))
            c["v"][i].index_copy_(1, pm, v.to(c["v"].dtype))
            if m not in live:
                live[m] = (torch.arange(self.max_len, device=q.device) <= pm)[None, None]
            return _attend_cache(q, c["k"][i], c["v"][i], live[m])

        for i in range(self.cfg.n_layers):
            layer["i"] = i
            x = self._block(i, x, attn)
        return self.logits(x)[:, 0]


@torch.no_grad()
def tp_generate(mesh: Mesh, params_tp: dict, cfg, prompt, max_new_tokens: int, *,
                temperature: float = 0.0, top_k: int | None = None, top_p: float | None = None,
                generator: torch.Generator | None = None):
    """Tensor-parallel :func:`~tpu_dist_nn_torch.models.generate.generate`:
    ``(B, max_new_tokens)`` int64 continuations of ``prompt (B, T)`` on the
    params' device. ``params_tp["blocks"]`` in ``tp_shard_blocks`` layout;
    ``B`` divisible by the data axis."""
    n, D = mesh.shape[AXIS_MODEL], mesh.shape[AXIS_DATA]
    if cfg.n_heads % n:
        raise ValueError(f"n_heads={cfg.n_heads} not divisible by model axis {n}")
    home = params_tp["tok_embed"].device
    prompt = torch.as_tensor(prompt, device=home).long()
    B, T = prompt.shape
    N = max_new_tokens
    validate_generate_args(cfg, T, N, temperature, top_k, top_p, generator)
    if B % D:
        raise ValueError(f"batch {B} not divisible by data axis {D}")
    params_c = cfg.cast_params(params_tp)
    shards = shard_views(params_c["blocks"], n)
    noise = draw_noise(generator, N, B, cfg.vocab_size, home) if temperature > 0 else None
    max_len = T + N - 1
    ready = caller_event(prompt)
    outs = []
    for d in range(D):
        cell = mesh.model_slots[0][d]
        rows = slice(d * (B // D), (d + 1) * (B // D))

        def run(rows_prompt, cell=cell, rows=rows):
            lead = cell[0].device
            state = _Shards(cfg, cell, [{k: v.to(slot.device) for k, v in sh.items()}
                                        for slot, sh in zip(cell, shards)],
                            {k: params_c[k].to(lead)
                             for k in ("tok_embed", "pos_embed", "lnf_g", "lnf_b")}, max_len)
            shard_noise = None if noise is None else noise[:, rows].to(lead)

            def sample(logits, step):
                return _sample(logits, None if shard_noise is None else shard_noise[step],
                               temperature, top_k, top_p)

            out = torch.empty((rows_prompt.shape[0], N), dtype=torch.long, device=lead)
            token = sample(state.prefill(rows_prompt)[:, T - 1], 0)
            out[:, 0] = token
            pos = torch.arange(max_len + 1, device=lead)
            for step in range(1, N):
                token = sample(state.decode(token, pos[T + step - 1:T + step]), step)
                out[:, step] = token
            return out

        outs.append(launch(cell[0], run, prompt[rows], ready))
    return torch.cat(gather(outs, home), dim=0)

"""Pipelined autoregressive decoding: generation with the blocks over stage slots.

Port of :mod:`tpu_dist_nn.parallel.pp_generate`. Decoding runs in the
training placement (:func:`~tpu_dist_nn_torch.parallel.transformer_pipeline.
shard_blocks`): each stage slot holds its block group and that group's KV
cache, an activation hops from stage to stage, and the sampled token goes
back from the last stage to the embedding on stage 0.

The JAX module computes every stage every tick and masks the cache
commits (one branch-free SPMD program). Here only the live work is
enqueued: each (stage, group, token) op runs once, on its stage slot's
stream, after the event of the op it reads (the stage before, or the
last stage's token); the host never waits inside the loop. Ops are
enqueued token by token, group by group, stage by stage, so each stream
runs its groups in the JAX tick order and, with ``G >= S`` groups, every
stage has a group to work on at every step, as in
:func:`make_pipeline_generate_overlapped`'s round robin.

Both decoders reuse :mod:`tpu_dist_nn_torch.models.generate`
(``prefill_blocks``, ``decode_blocks``, ``_sample``,
``validate_generate_args``), so greedy tokens equal the single-program
:func:`~tpu_dist_nn_torch.models.generate.generate` of each group bit for
bit (the same ops on the same shapes). Sampling draws the single
program's Gumbel noise, ``(N, rows, V)``, once a call from the caller's
generator, and every group reads the same draws: each group samples what
``generate`` would from a generator in the same state (the JAX contract:
groups share the one key schedule). Data shards take their rows of one
draw, so sampled streams equal the single program on any mesh (JAX folds
the shard index into its key instead).
"""

from __future__ import annotations

import torch

from tpu_dist_nn_torch.models.generate import (
    _TINY,
    _sample,
    decode_blocks,
    prefill_blocks,
    validate_generate_args,
)
from tpu_dist_nn_torch.models.transformer import layer_norm
from tpu_dist_nn_torch.parallel.gpipe import caller_event, gather, launch
from tpu_dist_nn_torch.parallel.mesh import AXIS_DATA, AXIS_STAGE, Mesh


def draw_noise(generator, steps: int, rows: int, vocab: int, device):
    """The single program's Gumbel draws, ``(steps, rows, vocab)`` float32
    (``GenerateProgram.start``'s, in the same order)."""
    noise = torch.zeros((steps, rows, vocab), dtype=torch.float32, device=device)
    return noise.uniform_(generator=generator).clamp_(min=_TINY).log_().neg_().log_().neg_()


def _unembed(top: dict, x):
    return layer_norm(x, top["lnf_g"], top["lnf_b"]) @ top["tok_embed"].T


class _Decode:
    """One pipelined decode over ``G`` groups of a data shard: the ops,
    their buffers and their hand-offs (see the module docstring)."""

    def __init__(self, mesh: Mesh, d: int, cfg, stages: list, top: list, prompts, N: int,
                 temperature, top_k, top_p, noise, ready):
        self.mesh, self.d, self.cfg, self.stages, self.top = mesh, d, cfg, stages, top
        self.S = len(stages)
        self.G, self.Bg, self.T = prompts.shape
        self.N, self.max_len = N, self.T + N - 1
        self.sample = lambda logits, n: _sample(
            logits, None if noise is None else noise[n], temperature, top_k, top_p)
        self.prompts, self.ready = prompts, ready
        self.cache = [[None] * self.G for _ in range(self.S)]

    def slot(self, s):
        return self.mesh.slots[s][self.d]

    def run(self):
        S, G, N, T = self.S, self.G, self.N, self.T
        last = self.slot(S - 1)
        # positions as device tensors on each stage, read by index (no
        # host-to-device copy inside the loop)
        pos = [torch.arange(self.max_len + 1, device=self.slot(s).device) for s in range(S)]
        tokens = [None] * G  # (tensor, event) of each group's latest token
        out = [None] * G
        for g in range(G):
            wire = (self.prompts[g], self.ready)
            for s in range(S):
                wire = launch(self.slot(s), lambda x, s=s, g=g: self._prefill(s, g, x), *wire)
            def first(y):
                # the whole prompt's logits, as the single program's prefill
                tok = self.sample(_unembed(self.top[S - 1], y)[:, T - 1], 0)
                buf = torch.empty((self.Bg, N), dtype=torch.long, device=last.device)
                buf[:, 0] = tok
                return buf, tok
            (out[g], tok), ev = launch(last, first, *wire)
            tokens[g] = (tok, ev)
        for n in range(N - 1):
            for g in range(G):
                wire = tokens[g]
                for s in range(S):
                    at = pos[s][T + n:T + n + 1]
                    wire = launch(self.slot(s),
                                  lambda x, s=s, g=g, at=at: self._decode(s, g, x, at), *wire)

                def nxt(y, g=g, n=n):
                    tok = self.sample(_unembed(self.top[S - 1], y)[:, 0], n + 1)
                    out[g][:, n + 1] = tok
                    return tok

                tok, ev = launch(last, nxt, *wire)
                tokens[g] = (tok, ev)
        return [(out[g], tokens[g][1]) for g in range(G)]

    def _prefill(self, s, g, x):
        top = self.top[s]
        if s == 0:
            x = top["tok_embed"][x.long()] + top["pos_embed"][: self.T]
        y, cache = prefill_blocks(self.stages[s], x, self.cfg, self.max_len)
        self.cache[s][g] = cache
        return y

    def _decode(self, s, g, x, pos):
        top = self.top[s]
        if s == 0:
            x = top["tok_embed"][x][:, None, :] + top["pos_embed"].index_select(0, pos)[None]
        y, _ = decode_blocks(self.stages[s], self.cache[s][g], pos, x, self.cfg)
        return y


def _pipelined(mesh: Mesh, cfg, num_stages: int, N: int, temperature, top_k, top_p):
    if mesh.shape[AXIS_STAGE] != num_stages:
        raise ValueError(f"num_stages={num_stages} but the mesh '{AXIS_STAGE}' axis has size "
                         f"{mesh.shape[AXIS_STAGE]}")
    D = mesh.shape[AXIS_DATA]

    @torch.no_grad()
    def run(params, prompts, generator):
        """``prompts (G, B, T)`` -> ``(G, B, T + N)`` on the params' device."""
        home = params["tok_embed"].device
        prompts = torch.as_tensor(prompts, device=home).long()
        G, B, T = prompts.shape
        if B % D:
            raise ValueError(f"batch {B} not divisible by data axis {D}")
        params = cfg.cast_params(params)
        noise = (draw_noise(generator, N, B, cfg.vocab_size, home) if temperature > 0 else None)
        ready = caller_event(prompts)
        results = []
        for d in range(D):
            rows = slice(d * (B // D), (d + 1) * (B // D))
            devs = [mesh.slots[s][d].device for s in range(num_stages)]
            stages = [{k: v[s].to(dev) for k, v in params["blocks"].items()}
                      for s, dev in enumerate(devs)]
            top = [{k: params[k].to(dev) for k in ("tok_embed", "pos_embed", "lnf_g", "lnf_b")}
                   for dev in devs]
            shard_noise = None if noise is None else noise[:, rows].to(devs[-1])
            results.append(_Decode(mesh, d, cfg, stages, top, prompts[:, rows], N, temperature,
                                   top_k, top_p, shard_noise, ready).run())
        new = gather([r for res in results for r in res], home)
        new = torch.stack([torch.cat([new[d * G + g] for d in range(D)]) for g in range(G)])
        return torch.cat([prompts, new], dim=2)

    return run


def make_pipeline_generate(mesh: Mesh, cfg, num_stages: int, max_new_tokens: int, *,
                           temperature: float = 0.0, top_k=None, top_p=None):
    """-> ``fn(params_staged, prompt (B, T), generator=None) -> (B, T + N)``.

    ``params_staged["blocks"]`` in ``shard_blocks`` layout (the training
    layout); the embedding and head replicated; the batch over ``data``.
    Greedy streams equal :func:`~tpu_dist_nn_torch.models.generate.
    generate`'s token for token on any mesh; sampled streams too (module
    docstring)."""
    N = max_new_tokens
    run = _pipelined(mesh, cfg, num_stages, N, float(temperature), top_k, top_p)

    def generate_fn(params, prompt, generator=None):
        prompt = torch.as_tensor(prompt)
        validate_generate_args(cfg, prompt.shape[1], N, temperature, top_k, top_p, generator)
        return run(params, prompt[None], generator)[0]

    return generate_fn


def make_pipeline_generate_overlapped(mesh: Mesh, cfg, num_stages: int, max_new_tokens: int,
                                      num_groups: int, *, temperature: float = 0.0, top_k=None,
                                      top_p=None):
    """Continuous-batching-style pipelined decode: ``G`` request groups
    round-robin through the stage ring, so that with ``G >= S`` every
    stage has a group to decode at every step.

    -> ``fn(params_staged, prompts (G, Bg, T), generator=None) -> (G, Bg,
    T + N)``, token for token equal to decoding each group alone (greedy
    and sampled; every group reads the same noise, as the JAX groups
    share one key schedule)."""
    S, N, G = num_stages, max_new_tokens, num_groups
    if G < S:
        raise ValueError(
            f"num_groups ({G}) must be >= num_stages ({S}): a group's "
            f"sampled token takes {S} ticks to cross the pipe and ride "
            f"the feedback hop, and the round-robin grants it G ticks "
            "before that group decodes again"
        )
    run = _pipelined(mesh, cfg, S, N, float(temperature), top_k, top_p)

    def generate_fn(params, prompts, generator=None):
        prompts = torch.as_tensor(prompts)
        if prompts.ndim != 3 or prompts.shape[0] != G:
            raise ValueError(
                f"prompts must be (num_groups={G}, Bg, T), got {tuple(prompts.shape)}"
            )
        validate_generate_args(cfg, prompts.shape[2], N, temperature, top_k, top_p, generator)
        return run(params, prompts, generator)

    return generate_fn

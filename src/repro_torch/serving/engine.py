"""Real-generation engine (Track B): batched sampling over a served model.

:class:`RealEngine` prefills right-padded prompts once, takes φ — the
last-layer hidden state of the last prompt token — for the ProD predictor,
then decodes until every row has sampled EOS or ``max_new`` tokens. Prefill
attention runs the flash kernel, prefill SSM layers the SSD scan kernel, and
every decode step's attention the split-KV kernel (``kernels/``), on the
device the parameters live on.

Sampling is temperature sampling through the Gumbel-max trick with a seeded
``torch.Generator`` on that device. ``jax.random`` draws other numbers from
the same seed, so the parity tests feed both frameworks the same tokens.
Nothing here reads the wall clock, a global RNG or a set's order.
``collect_per_step`` (per-step hidden states) waits for the online-predictor
slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.model_zoo import last_token_hidden


class RealEngine:
    """Batched sampling engine: prefill once, decode until EOS, harvest
    last-token hidden states for the ProD predictor."""

    def __init__(self, model, params, temperature: float = 0.8,
                 max_new: int = 256, eos_id: int = 2):
        self.model = model
        self.params = params
        self.temp = temperature
        self.max_new = max_new
        self.eos = eos_id
        self.device = params["embed"].device

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """Categorical draw from softmax(logits / T): argmax of the scaled
        logits plus Gumbel noise (-log of an Exp(1) draw)."""
        e = torch.empty_like(logits).exponential_(generator=gen)
        return torch.argmax(logits / self.temp - torch.log(e), dim=-1)

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, prompt_lens: np.ndarray,
                 gen: torch.Generator, collect_hidden: bool = True) -> Dict[str, np.ndarray]:
        """prompts: (B, Sp) right-padded. Returns lengths (B,), phi (B, d)
        fp32 (None without ``collect_hidden``) and tokens (B, max_new)."""
        dev = self.device
        B, Sp = prompts.shape
        tokens = torch.as_tensor(prompts, dtype=torch.long, device=dev)
        lens = torch.as_tensor(prompt_lens, dtype=torch.int32, device=dev)
        valid = torch.arange(Sp, device=dev)[None, :] < lens[:, None]
        _, hidden, prefill_cache = self.model.prefill(self.params, tokens, attn_valid=valid,
                                                      logits_mode="none")
        last = last_token_hidden(hidden, lens)
        phi = last.float().cpu().numpy() if collect_hidden else None
        # the reference unembeds every position and gathers the last one;
        # unembedding the gathered row gives the same logits
        cur_logits = self.model.unembed(self.params, last)

        # K/V grown to Sp + max_new positions; SSM states carried over
        cache = self.model.decode_cache(prefill_cache, Sp + self.max_new)
        del prefill_cache

        lengths = lens.clone()
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        out_tokens = torch.zeros((B, self.max_new), dtype=torch.int32, device=dev)
        gen_len = torch.zeros(B, dtype=torch.int64, device=dev)
        eos = torch.full((), self.eos, dtype=torch.long, device=dev)
        for step in range(self.max_new):
            nxt = torch.where(finished, eos, self._sample(cur_logits, gen))
            out_tokens[:, step] = nxt.to(torch.int32)
            newly = ~finished & (nxt == self.eos)
            finished = finished | (nxt == self.eos)
            gen_len = torch.where(newly, step + 1, gen_len)
            if bool(finished.all()):
                break
            cur_logits, _ = self.model.decode_step(self.params, nxt, cache,
                                                   pos=lengths, lengths=lengths + 1)
            lengths = lengths + (~finished).to(torch.int32)
        gen_len = torch.where(gen_len == 0, self.max_new, gen_len)
        return {"lengths": gen_len.cpu().numpy(), "phi": phi,
                "tokens": out_tokens.cpu().numpy()}

    def repeated_sampling(self, prompts: np.ndarray, prompt_lens: np.ndarray,
                          r: int, seed: int = 0):
        """The paper's data-collection loop: r independent generations per
        prompt. Returns (lengths (B, r) int64, phi (B, d) fp32)."""
        B = prompts.shape[0]
        lens = np.zeros((B, r), np.int64)
        phi = None
        for j in range(r):
            gen = torch.Generator(device=self.device).manual_seed(seed * 997 + j)
            out = self.generate(prompts, prompt_lens, gen, collect_hidden=(j == 0))
            lens[:, j] = out["lengths"]
            if j == 0:
                phi = out["phi"]
        return lens, phi

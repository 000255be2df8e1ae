"""Token sampling (port of whisperkit_tpu/decoding/sampler.py).

Temperature 0 → argmax; temperature > 0 → softmax over the top-k logits,
then one draw from a caller-owned `torch.Generator`. Torch generators and
JAX keys give different numbers from the same seed, so only greedy
decoding is held token-for-token against the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_token(
    logits: torch.Tensor,  # [B, V] f32, already filtered
    temperature: float,
    generator: Optional[torch.Generator] = None,
    top_k: int = 5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B] int64, logprob-of-token [B] f32)."""
    if temperature > 0:
        top_vals, top_idx = torch.topk(logits, top_k, dim=-1)
        probs = torch.softmax(top_vals / max(temperature, 1e-4), dim=-1)
        choice = torch.multinomial(probs, 1, generator=generator)  # [B, 1]
        token = torch.gather(top_idx, 1, choice)[:, 0]
    else:
        token = torch.argmax(logits, dim=-1)
    # logprob of the chosen token without materialising a full log_softmax
    norm = torch.logsumexp(logits, dim=-1)
    logprob = torch.gather(logits, 1, token[:, None])[:, 0] - norm
    return token, logprob

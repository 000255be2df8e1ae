"""Token sampling (port of whisperkit_tpu/decoding/sampler.py).

Temperature 0 → argmax; temperature > 0 → one draw from the softmax over
the top-k logits, as JAX's `jax.random.categorical` draws it: the argmax
of top_vals / T plus Gumbel noise, the noise made from uniform draws of a
caller-owned `torch.Generator`, or of a mesh shard's view of one
generator's whole-batch draws (parallel/mesh.SharedDraws), so that a seed
samples the same rows alike on one device and on several. Torch
generators and JAX keys give different numbers from the same seed, so only
greedy decoding is held token-for-token against the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from whisperkit_tpu_torch.parallel.mesh import gumbel


def sample_token(
    logits: torch.Tensor,  # [B, V] f32, already filtered
    temperature: float,
    generator=None,  # a torch.Generator, or a parallel.mesh.RowDraws view
    top_k: int = 5,
    noise: Optional[torch.Tensor] = None,  # [B, top_k] Gumbel noise drawn beforehand
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B] int64, logprob-of-token [B] f32). At temperature
    > 0 the noise is `noise` where given (a CUDA graph of the decode step
    reads it from a buffer the host fills before each replay: a draw from
    a generator inside the capture would be frozen into it), else the next
    draw of `generator`."""
    if temperature > 0:
        top_vals, top_idx = torch.topk(logits, top_k, dim=-1)
        if noise is None:
            noise = gumbel(generator, top_vals.shape, logits.device)
        choice = torch.argmax(top_vals / max(temperature, 1e-4) + noise, dim=-1, keepdim=True)  # [B, 1]
        token = torch.gather(top_idx, 1, choice)[:, 0]
    else:
        token = torch.argmax(logits, dim=-1)
    # logprob of the chosen token without materialising a full log_softmax
    norm = torch.logsumexp(logits, dim=-1)
    logprob = torch.gather(logits, 1, token[:, None])[:, 0] - norm
    return token, logprob

"""Rehearse the full transcription step over a dcn x dp x tp mesh before
any multi-card run (the counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`).

    python -m whisperkit_tpu_torch.tools.dryrun_multichip [--devices 8] [--device cpu]

`--devices` replicas of `--device` make the mesh: tp = 2 whenever the
count allows, an outer dcn = 2 from 8 devices, dp the rest. The tiny
model's weights are Megatron-split over tp (parallel/sharding.py), and the
step (encode the window batch, then a 4-token greedy decode) runs through
`dcn_shard`: once per dcn slice, each slice's cells in threads of their
own. Its tokens must equal the same step's on one device with the whole
tree. Then the sequence-parallel leg: each cell encodes one window with
its 1500 frames split over its tp ranks (replicated weights) and must
agree with the replicated encoder. One JSON line reports the mesh and the
checks; any disagreement raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from whisperkit_tpu_torch.decoding.loop import DecodeScalars, decode_loop, encode_window
from whisperkit_tpu_torch.models.whisper import VARIANT_DIMS, WhisperDims, encoder_forward, init_params
from whisperkit_tpu_torch.parallel.mesh import dcn_shard, gather_rows, make_mesh, shard_batch, shard_params_replicated
from whisperkit_tpu_torch.parallel.sharding import encoder_seq_sharding, shard_whisper_params
from whisperkit_tpu_torch.text.tokenizer import special_tokens_for_vocab

NEW_TOKENS = 4
ROWS_PER_CELL = 2
# float32 sums over tp ranks and frame shards run in another order than
# one device's: the encoder outputs agree to float32 rounding
ENC_TOL = 2e-5


def dryrun_multichip(n_devices: int = 8, device: str = "cpu", dims: WhisperDims = VARIANT_DIMS["tiny"]) -> dict:
    tp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    dcn = 2 if n_devices % (2 * tp) == 0 and n_devices >= 8 else 1
    dp = n_devices // (tp * dcn)
    plan = make_mesh(dp=dp, tp=tp, dcn=dcn, devices=[device] * n_devices)
    params = init_params(0, dims, torch.float32, device)
    sp = special_tokens_for_vocab(dims.n_vocab)
    batch = plan.n_cells * ROWS_PER_CELL
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal((batch, dims.n_mels, 3000)).astype(np.float32) * 0.5).to(device)
    prompt = torch.tensor([[sp.sot, sp.transcribe]] * batch, device=device)
    suppress = torch.zeros(dims.n_vocab, device=device)
    scalars = DecodeScalars(0.0, 50, float("-inf"))

    def step(tree, mel_rows, prompt_rows):
        _, ck, cv = encode_window(tree, mel_rows, dims)
        out = decode_loop(
            tree, ck, cv, prompt_rows, suppress.to(mel_rows.device), scalars, dims=dims, special=sp,
            sample_begin=prompt_rows.shape[1], max_new_tokens=NEW_TOKENS, top_k=5, sot_index=0,
            use_timestamp_rules=True, suppress_blank=False,
        )
        return out.tokens, out.no_speech_prob

    def on_slice(sub, trees, mel_rows, prompt_rows):
        mels, prompts = shard_batch(sub, mel_rows), shard_batch(sub, prompt_rows)
        out = sub.run(lambda g, r: step(trees[g][r], mels[g][r], prompts[g][r]))
        return tuple(gather_rows([cell[0][i] for cell in out], sub.first_device) for i in range(2))

    trees = shard_whisper_params(plan, params)
    tokens, nsp = dcn_shard(plan, on_slice, batch_argnums=(0, 1, 2))(trees, mel, prompt)
    ref_tokens, ref_nsp = step(params, mel, prompt)
    if tokens.shape != (batch, 2 + NEW_TOKENS) or not bool(torch.isfinite(nsp).all()):
        raise RuntimeError(f"mesh step: tokens {tuple(tokens.shape)}, no-speech finite {bool(torch.isfinite(nsp).all())}")
    if not torch.equal(tokens, ref_tokens):
        raise RuntimeError(f"mesh step's tokens differ from one device's:\n{tokens}\n{ref_tokens}")
    report = {"device": device, "devices": n_devices, "dcn": dcn, "dp": dp, "tp": tp, "batch": batch,
              "tokens_equal": True, "no_speech_max_abs": float((nsp - ref_nsp).abs().max())}

    if tp > 1:
        seq = encoder_seq_sharding(plan)
        replicas = shard_params_replicated(plan, params)
        cells = plan.cells()
        out = plan.run(lambda g, r: encoder_forward(
            replicas[cells[g][r]], mel[g : g + 1].to(cells[g][r]), dims, seq_group=seq[g][r]))
        ref = encoder_forward(params, mel[: plan.n_cells], dims)
        err = max(float((cell[r].to(ref.device) - ref[g : g + 1]).abs().max())
                  for g, cell in enumerate(out) for r in range(tp))
        if not err <= ENC_TOL:
            raise RuntimeError(f"sequence-parallel encoder off the replicated one by {err:.3e} > {ENC_TOL}")
        report["seq_parallel_max_abs"] = err
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    print(json.dumps(dryrun_multichip(args.devices, args.device)))


if __name__ == "__main__":
    main()

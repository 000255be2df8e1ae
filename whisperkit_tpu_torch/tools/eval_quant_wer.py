"""Quantization WER-delta table: each scheme vs bf16 with the SAME weight
tree (the port's counterpart of tools/eval_quant_wer.py).

Prints one JSON object per scheme: WER of the quantized transcript against
the bf16 transcript, token edit-distance rate and identity flags
(eval/quant_delta.quant_divergence), or with `--teacher-forced` the
per-step flip rate against bf16 on the same prefix
(eval/quant_delta.teacher_forced_divergence). With random-init weights the
transcripts are arbitrary token sequences, which makes this a sensitive
probe: any drift in decode decisions shows up, unsmoothed by language
priors.

    python -m whisperkit_tpu_torch.tools.eval_quant_wer                  # large-v3 on the card, all schemes
    python -m whisperkit_tpu_torch.tools.eval_quant_wer --teacher-forced
    python -m whisperkit_tpu_torch.tools.eval_quant_wer --variant tiny --device cpu

The audio is synthetic speech-like audio (tools/workload.py: clips of 11,
60 and 10 s, seeds 0-2), or the files named by `--audio`. The weights are
the port's random init (`init_params(seed=0)`) in bf16.

Reference metric: RegressionTests.swift:293-296 (WER vs reference
transcripts); the offline analog is delta-vs-bf16.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

SYNTH_SECONDS = (11.0, 60.0, 10.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", default="large-v3")
    ap.add_argument("--group", type=int, default=16)
    ap.add_argument("--sample-length", type=int, default=224)
    ap.add_argument(
        "--schemes", nargs="*", default=None,
        help="subset of scheme names (default: all in DEFAULT_SCHEMES)",
    )
    ap.add_argument(
        "--teacher-forced", action="store_true",
        help="per-step flip rate vs bf16 on the SAME prefix (no trajectory "
        "compounding) — the interpretable companion to the free-run table",
    )
    ap.add_argument("--audio", nargs="*", default=None, help="audio files (default: synthetic speech-like clips)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    from whisperkit_tpu_torch.audio.io import load_audio
    from whisperkit_tpu_torch.eval.quant_delta import (
        DEFAULT_SCHEMES,
        quant_divergence,
        teacher_forced_divergence,
    )
    from whisperkit_tpu_torch.models.whisper import VARIANT_DIMS, init_params
    from whisperkit_tpu_torch.tools.workload import pipeline_options, synth_speechlike_audio

    if args.audio:
        audio_list = [load_audio(p) for p in args.audio]
    else:
        audio_list = [synth_speechlike_audio(s, seed=i) for i, s in enumerate(SYNTH_SECONDS)]
    dims = VARIANT_DIMS[args.variant]
    params = init_params(0, dims, torch.bfloat16, args.device)
    options = dataclasses.replace(pipeline_options(args.group), sample_length=args.sample_length)
    schemes = {k: DEFAULT_SCHEMES[k] for k in args.schemes} if args.schemes else None
    if args.teacher_forced:
        reports = teacher_forced_divergence(
            dims, params, audio_list[0], language="en", schemes=schemes,
            max_tokens=args.sample_length, device=args.device,
        )
    else:
        reports = quant_divergence(dims, params, audio_list, options, schemes, device=args.device)
    for r in reports:
        print(json.dumps({"variant": args.variant, "device": args.device, **dataclasses.asdict(r)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""DiarizePipeline: speaker diarization façade and engine (port of
whisperkit_tpu/pipelines/diarize.py).

Reference: Sources/SpeakerKit/SpeakerKit.swift (façade :21-108) and
Pyannote/PyannoteDiarizer.swift (`PyannoteDiarizerActor`: producer-consumer
segmenter→embedder pipeline :145-231, clustering :233-269, post-processing
:271-364, `diarize` :366-403), PyannoteConfig.swift (config/options/timings
:122-210).

Both models are batched, as in the JAX package, but in blocks of at most
BLOCK_ROWS rows: the chunks go through the segmenter and the (chunk,
speaker slot) pairs through the embedder BLOCK_ROWS at a time, so the card
sees large batches and the activations' memory stays that of one block
however long the audio (the JAX package's one batch of every pair takes
~0.1 GiB a pair with the published ResNet34). Clustering and the overlap
aggregation stay on the host (NumPy/scipy). The pipeline runs on
`device`: one device ("cuda", the current card, by default) or a sequence
of them. The chunks and the (chunk, speaker slot) pairs split over a
data-parallel mesh of those devices (parallel/mesh.py; one cell on one
device), one thread per device with its own replica of the models, each
taking its rows BLOCK_ROWS at a time; the rows padded in to give every
device equal rows (copies of the last) are dropped before the clustering.
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch

from whisperkit_tpu_torch.audio.io import SAMPLE_RATE, load_audio
from whisperkit_tpu_torch.models.pyannet import (
    load_pyannote_segmentation,
    load_wespeaker_resnet34,
    params_from_numpy,
    powerset_to_activity,
    prepare_params,
    pyannet_forward,
    tree_to,
    wespeaker_embed_masked,
)
from whisperkit_tpu_torch.models.params_npz import read_params_npz
from whisperkit_tpu_torch.models.pyannote import (
    CHUNK_SAMPLES,
    EmbedderDims,
    SegmenterDims,
    embedder_forward,
    init_embedder,
    init_segmenter,
    segmenter_forward,
)
from whisperkit_tpu_torch.ops.fbank import kaldi_fbank
from whisperkit_tpu_torch.ops.mel import log_mel_spectrogram
from whisperkit_tpu_torch.ops.quant import quantize_speaker_params
from whisperkit_tpu_torch.parallel.mesh import Devices, make_mesh, resolve_devices
from whisperkit_tpu_torch.speaker.clustering import VBxClusterer, VBxClusteringConfig
from whisperkit_tpu_torch.speaker.results import DiarizationResult, SpeakerMergeStrategy


@dataclasses.dataclass
class DiarizationOptions:
    """Reference: PyannoteDiarizationOptions (PyannoteConfig.swift:122-146)."""

    number_of_speakers: Optional[int] = None
    min_active_offset: float = 1.0
    cluster_distance_threshold: Optional[float] = None
    min_cluster_size: int = 1
    use_exclusive_reconciliation: bool = True
    clip_timestamps: Sequence[float] = ()
    min_activity_threshold: float = 0.5


@dataclasses.dataclass
class DiarizationTimings:
    """Reference: PyannoteDiarizationTimings (PyannoteConfig.swift:150-210).
    On the card each stage ends with a device sync, so the split is the
    card's."""

    segmenter_seconds: float = 0.0
    embedder_seconds: float = 0.0
    clustering_seconds: float = 0.0
    post_process_seconds: float = 0.0
    total_seconds: float = 0.0
    chunk_count: int = 0
    embedding_count: int = 0


@dataclasses.dataclass
class PyannoteConfig:
    """Reference: PyannoteConfig (PyannoteConfig.swift:11-41)."""

    stride_seconds: float = 15.0  # chunk overlap stride (fullRedundancy)
    pyannet_stride_seconds: float = 5.0  # real PyanNet uses 10 s windows
    segmenter_dims: SegmenterDims = dataclasses.field(default_factory=SegmenterDims)
    embedder_dims: EmbedderDims = dataclasses.field(default_factory=EmbedderDims)
    clustering: VBxClusteringConfig = dataclasses.field(default_factory=VBxClusteringConfig)
    seed: int = 0


PYANNET_CHUNK_SAMPLES = 160_000  # 10 s windows (pyannote/segmentation-3.0)
# rows per segmenter or embedder call: diarizing 600 s with the published
# models in blocks of 64 peaked at 13 GiB on an H100 (one batch of all 357
# embeddings: 36 GiB)
BLOCK_ROWS = 64

# checkpoint file names `from_pretrained` recognises, in order of preference
SEGMENTER_GLOBS = (
    "segmentation*.ckpt", "segmentation*.bin", "segmentation*.safetensors", "pyannet*.ckpt", "pyannet*.bin",
)
EMBEDDER_GLOBS = (
    "*wespeaker*.bin", "*wespeaker*.safetensors", "*wespeaker*.ckpt",
    "embedder*.bin", "embedder*.safetensors", "embedder*.ckpt",
)


def _pyannet_frames(samples: int) -> int:
    """PyanNet frame count: sinc conv (k=251, stride 10) then 3× (pool 3 +
    valid k=5 conv after the first block)."""
    t = (samples - 251) // 10 + 1
    t //= 3
    t = t - 4
    t //= 3
    t = t - 4
    return t // 3


def find_pyannote_checkpoints(folder: Union[str, Path]) -> Optional[tuple[Path, Path]]:
    """(segmenter file, embedder file) in `folder`, or None unless both are
    there."""

    def find(globs):
        for g in globs:
            hits = sorted(Path(folder).glob(g))
            if hits:
                return hits[0]
        return None

    seg, emb = find(SEGMENTER_GLOBS), find(EMBEDDER_GLOBS)
    return (seg, emb) if seg is not None and emb is not None else None


class DiarizePipeline:
    """Reference: SpeakerKit + PyannoteDiarizerActor."""

    # Variant matrix (reference: PyannoteConfig.swift:11-41, the W8A16 /
    # W32A32 ModelInfos per platform). w16a16 rounds every float weight of
    # two or more axes to bf16; w8a16 quantizes the LSTM kernels, linears
    # and BN-folded convs (ops/quant.quantize_speaker_params). Activations
    # are float32 in all three, as in the JAX package.
    VARIANTS = ("w32a32", "w16a16", "w8a16")

    def __init__(
        self,
        config: Optional[PyannoteConfig] = None,
        *,
        segmenter_params=None,
        embedder_params=None,
        device: Devices = "cuda",
    ):
        self.devices = resolve_devices(device)
        self.device = self.devices[0]
        # the data-parallel mesh over every device
        self._plan = make_mesh(dp=len(self.devices), devices=self.devices)
        self.config = config or PyannoteConfig()
        if segmenter_params is None:
            segmenter_params = init_segmenter(torch.Generator().manual_seed(self.config.seed),
                                              self.config.segmenter_dims)
        if embedder_params is None:
            embedder_params = init_embedder(torch.Generator().manual_seed(self.config.seed + 1),
                                            self.config.embedder_dims)
        self.segmenter_params = prepare_params(segmenter_params, self.device)
        self.embedder_params = prepare_params(embedder_params, self.device)
        # each further mesh cell's own replica (its own segmenter LSTM module)
        self._replicas = [(self.segmenter_params, self.embedder_params)] + [
            (prepare_params(segmenter_params, cell[0]), prepare_params(embedder_params, cell[0]))
            for cell in self._plan.cells()[1:]
        ]
        # converted checkpoints (models/pyannet.py) are told apart by their
        # structure; the conv models stay the random-init default
        self.segmenter_backend = "pyannet" if "sinc" in self.segmenter_params else "conv"
        self.embedder_backend = "resnet" if "layer1" in self.embedder_params else "conv"
        self.timings = DiarizationTimings()

    @staticmethod
    def apply_variant(params, variant: str):
        """A CPU parameter tree in the precision of `variant` (VARIANTS)."""
        if variant == "w16a16":
            return tree_to(params, dtype_fn=lambda x: x.to(torch.bfloat16)
                           if x.dtype == torch.float32 and x.ndim >= 2 else x)
        if variant == "w8a16":
            return quantize_speaker_params(params)
        return params

    @classmethod
    def from_pretrained(
        cls,
        model_folder: Optional[Union[str, Path]] = None,
        variant: str = "w32a32",
        **kwargs,
    ) -> "DiarizePipeline":
        """Load the published models from `model_folder`, or the random-init
        conv models when no folder is given.

        The folder holds torch checkpoints: `segmentation*.{ckpt,bin,
        safetensors}` (pyannote/segmentation-3.0 PyanNet) and
        `*wespeaker*` / `embedder*.{bin,safetensors,ckpt}` (ResNet34),
        converted by models/pyannet.py (`tools/checkpoint.
        write_pyannote_checkpoint` writes such a folder); or the JAX
        package's pre-converted pair `segmenter.npz` + `embedder.npz`
        (models/params_npz.py: numpy leaves only). A folder with neither
        raises FileNotFoundError. `variant` selects the precision recipe
        (VARIANTS), as the reference resolves its variants per platform."""
        if variant not in cls.VARIANTS:
            raise ValueError(f"unknown pyannote variant {variant!r}; one of {cls.VARIANTS}")
        if model_folder is None:
            return cls(**kwargs)
        found = find_pyannote_checkpoints(model_folder)
        if found is not None:
            seg, emb = load_pyannote_segmentation(found[0]), load_wespeaker_resnet34(found[1])
        elif all((Path(model_folder) / f"{n}.npz").exists() for n in ("segmenter", "embedder")):
            seg, emb = (params_from_numpy(read_params_npz(Path(model_folder) / f"{n}.npz"))
                        for n in ("segmenter", "embedder"))
        else:
            raise FileNotFoundError(
                f"no pyannote checkpoints in {model_folder} (need one of {SEGMENTER_GLOBS} and one of "
                f"{EMBEDDER_GLOBS}, or segmenter.npz and embedder.npz)"
            )
        return cls(
            segmenter_params=cls.apply_variant(seg, variant),
            embedder_params=cls.apply_variant(emb, variant),
            **kwargs,
        )

    def _on_devices(self, rows: np.ndarray, fn) -> np.ndarray:
        """fn(device, (segmenter, embedder) params, rows) → a numpy array
        with one entry per row, run on the mesh: each cell takes its share
        of `rows` (padded to equal shares with copies of the last row) on
        its device, in its own thread (inline for one cell); the shares
        come back in row order, the padding dropped."""
        n = len(rows)
        padded = np.concatenate([rows, np.repeat(rows[-1:], self._plan.pad_batch(n) - n, axis=0)])
        slices = self._plan.row_slices(len(padded))
        cells = self._plan.cells()
        out = self._plan.run(lambda g, r: fn(cells[g][r], self._replicas[g], padded[slices[g]]))
        return np.concatenate([cell[0] for cell in out])[:n]

    # -- engine -------------------------------------------------------------

    def diarize(
        self,
        audio: Union[str, Path, np.ndarray],
        options: Optional[DiarizationOptions] = None,
        progress=None,
    ) -> DiarizationResult:
        options = options or DiarizationOptions()
        t_start = time.perf_counter()
        if isinstance(audio, (str, Path)):
            audio = load_audio(audio)
        audio = np.asarray(audio, np.float32)
        if options.clip_timestamps:
            s = int(options.clip_timestamps[0] * SAMPLE_RATE)
            e = (
                int(options.clip_timestamps[1] * SAMPLE_RATE)
                if len(options.clip_timestamps) > 1
                else len(audio)
            )
            audio = audio[s:e]

        sdims = self.config.segmenter_dims
        pyannet = self.segmenter_backend == "pyannet"
        chunk_samples = PYANNET_CHUNK_SAMPLES if pyannet else CHUNK_SAMPLES
        stride_s = self.config.pyannet_stride_seconds if pyannet else self.config.stride_seconds
        stride = int(stride_s * SAMPLE_RATE)
        chunk_starts = list(range(0, max(len(audio) - 1, 1), stride))
        # drop trailing strided chunks whose audio span is fully covered by
        # the previous chunk (they'd contribute only zero padding)
        chunk_starts = [c for c in chunk_starts if c == 0 or c - stride + chunk_samples < len(audio)]
        chunks = np.stack([_pad_to(audio[c : c + chunk_samples], chunk_samples) for c in chunk_starts])
        n_chunks = len(chunk_starts)
        self.timings.chunk_count = n_chunks

        # ---- segmenter (batched, BLOCK_ROWS chunks a call, per device) ---
        t0 = time.perf_counter()

        def segment(dev, models, rows):
            x = torch.from_numpy(rows).to(dev)
            if pyannet:
                act = [powerset_to_activity(pyannet_forward(models[0], x[b])) for b in _blocks(len(rows))]
            else:
                act = [segmenter_forward(models[0], x[b], sdims)["speaker_activity"] for b in _blocks(len(rows))]
            return torch.cat(act).cpu().numpy()

        activity = self._on_devices(chunks, segment)
        if pyannet:
            frames = activity.shape[1]
            n_slots = activity.shape[2]
        else:
            frames = sdims.frames_per_chunk
            n_slots = sdims.n_local_speakers
        frame_sec = chunk_samples / SAMPLE_RATE / frames
        self.timings.segmenter_seconds = time.perf_counter() - t0
        if progress:
            progress(0.4)

        # ---- embedder (batched over (chunk, slot) pairs, BLOCK_ROWS a call)
        t0 = time.perf_counter()
        active = activity > options.min_activity_threshold  # [C, F, S]
        pairs = [(c, s) for c in range(n_chunks) for s in range(n_slots) if active[c, :, s].any()]
        embeddings = np.zeros((0, self.config.embedder_dims.embedding_dim), np.float32)
        ratios: list[float] = []
        if pairs:
            resnet = self.embedder_backend == "resnet"

            def embed(dev, models, pair_rows):
                # every device computes the features of all chunks, as one
                # device does, and embeds its (chunk, slot) pairs from them
                chunks_dev = torch.from_numpy(chunks).to(dev)
                rows = torch.from_numpy(pair_rows[:, 0]).to(dev)
                if resnet:
                    # [C, F_fb, 80]; the CMN runs over active frames in the embedder
                    feats = kaldi_fbank(chunks_dev, mean_norm=False)
                    f_fb = feats.shape[1]
                    # map each 10 ms fbank frame onto the segmenter frame grid
                    seg_idx = np.minimum(np.arange(f_fb) * frames // f_fb, frames - 1)
                    masks = np.stack([activity[c, seg_idx, s] for c, s in pair_rows])
                else:
                    mel_frames = 3000  # 30 s of 10 ms mel frames
                    feats = log_mel_spectrogram(chunks_dev, n_mels=self.config.embedder_dims.n_mels)  # [C, M, 3000]
                    # upsample the activity to the mel frame grid for masking
                    masks = np.stack(
                        [np.repeat(activity[c, :, s], mel_frames // frames)[:mel_frames] for c, s in pair_rows])
                masks = torch.from_numpy(masks.astype(np.float32)).to(dev)
                out = []
                for b in _blocks(len(pair_rows)):
                    if resnet:
                        out.append(wespeaker_embed_masked(models[1], feats[rows[b]], masks[b]))
                    else:
                        out.append(embedder_forward(models[1], feats[rows[b]], masks[b], self.config.embedder_dims))
                return torch.cat(out).cpu().numpy()

            embeddings = self._on_devices(np.asarray(pairs, np.int64), embed)
            if resnet:
                embeddings = embeddings / (np.linalg.norm(embeddings, axis=-1, keepdims=True) + 1e-8)
            ratios = [float(active[c, :, s].mean()) for c, s in pairs]
        self.timings.embedder_seconds = time.perf_counter() - t0
        self.timings.embedding_count = len(pairs)
        if progress:
            progress(0.7)

        # ---- clustering ---------------------------------------------------
        t0 = time.perf_counter()
        cconf = dataclasses.replace(
            self.config.clustering,
            cluster_distance_threshold=(
                options.cluster_distance_threshold
                if options.cluster_distance_threshold is not None
                else self.config.clustering.cluster_distance_threshold
            ),
            min_cluster_size=options.min_cluster_size,
        )
        clusterer = VBxClusterer(cconf)
        for emb, ratio in zip(embeddings, ratios):
            clusterer.add(emb, ratio)
        labels = clusterer.cluster(options.number_of_speakers)
        self.timings.clustering_seconds = time.perf_counter() - t0
        if progress:
            progress(0.85)

        # ---- post-process: aggregate overlapped windows -------------------
        t0 = time.perf_counter()
        n_speakers = int(labels.max()) + 1 if len(labels) else 0
        total_frames = math.ceil(len(audio) / SAMPLE_RATE / frame_sec)
        counts = np.zeros((max(n_speakers, 1), total_frames), np.float32)
        weights = np.zeros(total_frames, np.float32)
        for (c, s), label in zip(pairs, labels):
            f0 = int(round(chunk_starts[c] / SAMPLE_RATE / frame_sec))
            span = min(frames, total_frames - f0)
            if span <= 0:
                continue
            counts[label, f0 : f0 + span] += activity[c, :span, s]
            weights[f0 : f0 + span] += 1.0
        weights = np.maximum(weights, 1.0)
        avg = counts / weights  # [K, total_frames]

        if options.use_exclusive_reconciliation:
            # exclusive top-1: a frame belongs to its strongest speaker only
            binary = np.zeros_like(avg, dtype=bool)
            any_active = avg.max(0) > options.min_activity_threshold
            top = avg.argmax(0)
            binary[top[any_active], np.nonzero(any_active)[0]] = True
        else:
            binary = avg > options.min_activity_threshold
        self.timings.post_process_seconds = time.perf_counter() - t0

        result = DiarizationResult.from_activity_matrix(binary, frame_sec, options.min_active_offset)
        self.timings.total_seconds = time.perf_counter() - t_start
        result.timings = dataclasses.asdict(self.timings)
        if progress:
            progress(1.0)
        return result

    # -- transcript merge (reference: SpeakerKit.generateRTTM + merge) ------

    @staticmethod
    def merge_with_transcript(
        diarization: DiarizationResult,
        transcription,
        strategy: SpeakerMergeStrategy = SpeakerMergeStrategy.SEGMENT,
    ):
        return diarization.add_speaker_info(transcription, strategy)


def _blocks(n: int) -> list[slice]:
    """[0, n) in slices of at most BLOCK_ROWS."""
    return [slice(i, min(i + BLOCK_ROWS, n)) for i in range(0, n, BLOCK_ROWS)]


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    if len(x) >= n:
        return x[:n]
    return np.concatenate([x, np.zeros(n - len(x), x.dtype)])

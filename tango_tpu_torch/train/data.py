"""Training data: manifests and the featurizing loader, port of
tango_tpu/train/data.py.

A background thread reads and resamples the batch's WAVs, mixes extra rows
(`augment_num`) and computes fbanks on the host while the card runs the
previous step; `num_prefetch` batches are queued. `decode_workers > 0`
decodes in a spawned process pool instead of the thread. Manifests are the
reference's JSON lines ({"dataset", "location", "captions"}).

The audio may be WAV, FLAC, mp3 (MPEG Layer I/II/III), Ogg Vorbis, Ogg Opus
or AIFF, mixed in one manifest (audio/wav.py dispatches by magic bytes).
`validate_manifest` refuses a missing file or another format before
training starts; a file that fails to decode later becomes the reference's
constant waveform, as in JAX.
"""

from __future__ import annotations

import json
import queue
import random
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np

from tango_tpu_torch.audio.mix import mix_pairs
from tango_tpu_torch.audio.stft import MelSpectrogram, wav_batch_to_fbank
from tango_tpu_torch.audio.wav import read_wav_file, sniff_format


@dataclass
class Example:
    location: str
    caption: str


def load_manifest(path: str, prefix: str = "", text_column: str = "captions",
                  audio_column: str = "location", text_prefix: str = "") -> List[Example]:
    """Read a manifest: one JSON object, a list, {"data": [...]} or JSON lines.

    `prefix` is prepended to audio paths, `text_prefix` to every caption (the
    reference's --prefix). An explicit `text_column` must exist in every row;
    the default takes "captions" or else "caption"."""
    with open(path) as f:
        content = f.read().strip()
    try:
        obj = json.loads(content)
        rows = obj["data"] if isinstance(obj, dict) and "data" in obj else obj
        if isinstance(rows, dict):
            rows = [rows]
    except json.JSONDecodeError:
        rows = [json.loads(line) for line in content.splitlines() if line.strip()]
    examples = []
    for r in rows:
        if text_column != "captions":
            caption = r[text_column]
        elif "captions" in r:
            caption = r["captions"]
        else:
            caption = r.get("caption", "")
        examples.append(Example(prefix + r[audio_column], text_prefix + caption))
    return examples


def validate_manifest(examples: Sequence[Example], max_report: int = 20) -> None:
    """Preflight before training: every file must exist and sniff as a
    format the port decodes (WAV, FLAC, mp3, Ogg Vorbis, AIFF, Ogg Opus).

    Opus packets decode through the system libopus, whose presence is
    checked at the first Opus file; a manifest that holds Opus without it
    raises ValueError, as does a missing or unrecognised file."""
    from tango_tpu_torch.audio.opus import libopus_available

    bad = []
    opus_checked = False
    for ex in examples:
        try:
            fmt = sniff_format(ex.location)
        except OSError as e:
            bad.append(f"{ex.location}: {e.strerror or e}")
        else:
            if fmt == "opus" and not opus_checked:
                if not libopus_available():
                    raise ValueError(
                        "manifest preflight failed: the manifest contains Ogg Opus audio "
                        f"({ex.location}) but the system libopus shared library is not "
                        "loadable; install libopus0 or transcode to wav/flac/mp3/ogg-vorbis")
                opus_checked = True
            if fmt not in ("wav", "flac", "mp3", "ogg", "aiff", "opus"):
                bad.append(f"{ex.location}: {fmt}")
        if len(bad) > max_report:
            break
    if bad:
        more = "" if len(bad) <= max_report else f"\n  ... (more than {max_report})"
        raise ValueError(f"manifest preflight failed: {len(bad)}+ undecodable audio files "
                         "(supported: WAV, FLAC, mp3/MPEG-1/2, Ogg Vorbis, AIFF, Ogg Opus):\n  "
                         + "\n  ".join(bad[:max_report]) + more)


def _decode_one(args):
    """Worker-side read_wav_file: the waveform, or None for a file that
    fails to decode (the parent substitutes the constant waveform). Raises
    nothing itself: an exception would poison the pool's map."""
    location, segment_samples = args
    try:
        return read_wav_file(location, segment_samples)
    except Exception:
        return None


class FeaturizedLoader:
    """Batches of {fbank (B, L, n_mels) float32 numpy, captions, waveforms}.

    The text encoding (tokenizer and frozen T5) is not here: the trainer
    side owns it, as in JAX. `local_rows` keeps only a slice of every batch
    (each process of a multi-process run featurizes its own rows of one
    global batch order); `augment_num` then counts that slice's mixed rows."""

    def __init__(
        self,
        examples: Sequence[Example],
        batch_size: int,
        target_length: int = 1024,
        stft: Optional[MelSpectrogram] = None,
        augment_num: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        num_prefetch: int = 2,
        drop_last: bool = True,
        local_rows: Optional[slice] = None,
        decode_workers: int = 0,
    ):
        if local_rows is not None and not drop_last:
            raise ValueError("local_rows requires drop_last=True")
        self.examples = list(examples)
        self.batch_size = batch_size
        self.local_rows = local_rows
        self.target_length = target_length
        self.stft = stft or MelSpectrogram()
        self.augment_num = augment_num
        self.shuffle = shuffle
        self.seed = seed
        self.num_prefetch = num_prefetch
        self.drop_last = drop_last
        self.decode_workers = decode_workers
        self._pool = None
        self._epoch = 0

    def _get_pool(self):
        if self._pool is None:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            self._pool = ProcessPoolExecutor(self.decode_workers,
                                             mp_context=mp.get_context("spawn"))
        return self._pool

    def close(self):
        """Shut the decode pool down (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __len__(self):
        n = len(self.examples) // self.batch_size
        if not self.drop_last and len(self.examples) % self.batch_size:
            n += 1
        return n

    def _load_batch(self, batch: List[Example], rng: random.Random):
        seg = self.target_length * 160
        captions = [ex.caption for ex in batch]
        if self.decode_workers > 0:
            decoded = list(self._get_pool().map(_decode_one, [(ex.location, seg) for ex in batch]))
        else:
            decoded = [_decode_one((ex.location, seg)) for ex in batch]
        waves = []
        for w in decoded:
            # an unreadable file: the reference's constant waveform
            waves.append(0.5 * np.ones((1, seg), np.float32) if w is None else w)
        waves = np.concatenate(waves, 0)
        if self.augment_num > 0 and len(batch) > 1:
            mixed, mixed_caps = mix_pairs(waves, captions, self.augment_num, rng=rng)
            if len(mixed):
                waves = np.concatenate([waves, mixed], 0)
                captions = captions + mixed_caps
        fbank, _ = wav_batch_to_fbank(self.stft, waves, self.target_length)
        return {"fbank": fbank.numpy(), "captions": captions, "waveforms": waves}

    def __iter__(self) -> Iterator[dict]:
        order = list(range(len(self.examples)))
        rng = random.Random(self.seed + self._epoch)
        self._epoch += 1
        if self.shuffle:
            rng.shuffle(order)
        batches = [[self.examples[i] for i in order[k: k + self.batch_size]]
                   for k in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.local_rows is not None:
            batches = [b[self.local_rows] for b in batches]

        q: "queue.Queue" = queue.Queue(maxsize=self.num_prefetch)
        stop = object()
        abandoned = threading.Event()

        def worker():
            # a batch-level failure reaches the consumer: swallowing it would
            # truncate the epoch silently
            try:
                for b in batches:
                    item = self._load_batch(b, rng)
                    # give up if the consumer abandoned the iterator, instead of
                    # blocking on the full queue forever
                    while not abandoned.is_set():
                        try:
                            q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if abandoned.is_set():
                        return
                q.put(stop)
            except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            abandoned.set()
            while not q.empty():  # unblock a worker stuck on a full queue
                q.get_nowait()

"""Serving: a programmatic Predictor, a batching one, an HTTP server and the
CLI; port of tango_tpu/serve.py.

`Predictor` follows the reference's cog predictor (predict.py:29-60): the
weights load once in `setup`, each `predict` generates one clip and writes a
WAV. `BatchingPredictor` coalesces concurrent `predict` calls that share
(steps, guidance) within `max_wait_ms` into one `generate_for_batch` call
padded to `max_batch` (a power of two); a seeded request is served alone, so
that its output is the single-prompt output at that seed. Both take
`music=True` to serve Mustango (pipeline_music.py) the same way; its
warm-ups pass empty beats and chords, so the predictors do not run. The CLI:

    python -m tango_tpu_torch.serve --model <snapshot_dir> --prompt "a dog barks" \
        --steps 100 --guidance 3 --output out.wav [--samples 2] [--device cpu]
    python -m tango_tpu_torch.serve --model <snapshot_dir> --listen 8000
    python -m tango_tpu_torch.serve --music --model <mustango_snapshot> --prompt "a jazz tune"

Server mode (`--listen PORT`) puts a BatchingPredictor behind a stdlib
ThreadingHTTPServer: GET /healthz, POST /generate {"prompt", "steps",
"guidance", "seed"} -> audio/wav. It runs on the card unless --device names
another. `--model` is a reference-format snapshot directory (with `--music`,
a released-layout Mustango snapshot): the port downloads nothing.
"""

from __future__ import annotations

import argparse
import os
import threading
import time
from typing import List, Optional, Sequence


class Predictor:
    """cog-style predictor (predict.py:29-60)."""

    def __init__(self):
        self.tango = None
        self.music = False

    def setup(self, model: str = "declare-lab/tango", quant: Optional[str] = None,
              music: bool = False, device=None):
        """Load the snapshot directory `model` (Tango's, or with `music`
        Mustango's) on `device` (the card by default) and warm up with one
        100-step generate, so that a warm-up failure is a setup failure and
        the first request's latency is steady."""
        self.music = music
        if music:
            from tango_tpu_torch import pipeline_music

            self.tango = pipeline_music.Mustango(model, quant=quant, device=device)
        else:
            from tango_tpu_torch import pipeline

            self.tango = pipeline.Tango(model, quant=quant, device=device)
        self.tango.generate("warmup", steps=100, **self._warm_features())

    def _warm_features(self) -> dict:
        """Empty beats and chords for Mustango's warm-ups: the predictors do
        not run, and the sampler's shapes do not depend on the features."""
        if not self.music:
            return {}
        return {"beats": [[], []], "chords": [], "chords_times": []}

    def predict(self, prompt: str, steps: int = 100, guidance: float = 3.0,
                output_path: str = "output.wav", seed: Optional[int] = None) -> str:
        from tango_tpu_torch.audio.wav import write_wav

        assert self.tango is not None, "call setup() first"
        wav = self.tango.generate(prompt, steps=steps, guidance=guidance, seed=seed)
        write_wav(output_path, wav, 16000)
        return output_path

    def predict_batch(self, prompts: Sequence[str], steps: int = 100, guidance: float = 3.0,
                      output_paths: Optional[Sequence[str]] = None, seed: Optional[int] = None,
                      batch_size: int = 4) -> List[str]:
        """Serve several prompts in one generation padded to `batch_size` (a
        power of two) by repeating the first prompt; the extra rows are
        dropped, so every request takes one of a few batch shapes."""
        from tango_tpu_torch.audio.wav import write_wav

        assert self.tango is not None, "call setup() first"
        assert batch_size & (batch_size - 1) == 0, "batch_size must be a power of 2"
        prompts = list(prompts)
        if not prompts:
            return []
        n = len(prompts)
        padded = prompts + [prompts[0]] * (-n % batch_size)
        wavs = self.tango.generate_for_batch(padded, steps=steps, guidance=guidance,
                                             batch_size=batch_size, seed=seed)[:n]
        output_paths = list(output_paths or [f"output_{i}.wav" for i in range(n)])
        for path, wav in zip(output_paths, wavs):
            write_wav(path, wav, 16000)
        return output_paths


class _Request:
    __slots__ = ("prompt", "steps", "guidance", "output_path", "seed", "done", "result",
                 "error")

    def __init__(self, prompt, steps, guidance, output_path, seed):
        self.prompt, self.steps, self.guidance = prompt, steps, guidance
        self.output_path, self.seed = output_path, seed
        self.done = threading.Event()
        self.result = None
        self.error = None


class BatchingPredictor(Predictor):
    """A Predictor that coalesces concurrent predict() calls.

    Requests that arrive within `max_wait_ms` of the first queued one and
    share its (steps, guidance) ride one generation padded to `max_batch`.
    Seeded requests are served alone: a shared batch would change their
    noise against the single-prompt path's."""

    def __init__(self, max_batch: int = 4, max_wait_ms: float = 50.0):
        super().__init__()
        assert max_batch & (max_batch - 1) == 0, "max_batch must be a power of 2"
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._queue: List[_Request] = []
        self._lock = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._shutdown = False

    def setup(self, model: str = "declare-lab/tango", quant: Optional[str] = None,
              music: bool = False, device=None):
        super().setup(model, quant=quant, music=music, device=device)
        # warm the batch shape too: it is the steady-state server shape
        warm = {k: [v] * self.max_batch for k, v in self._warm_features().items()}
        self.tango.generate_for_batch(["warmup"] * self.max_batch, steps=100,
                                      batch_size=self.max_batch, **warm)
        self._worker = threading.Thread(target=self._serve_loop, daemon=True)
        self._worker.start()

    def close(self):
        """Stop the worker; pending requests fail instead of hanging."""
        with self._lock:
            self._shutdown = True
            for r in self._queue:
                r.error = RuntimeError("BatchingPredictor closed")
                r.done.set()
            self._queue.clear()
            self._lock.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5)

    def predict(self, prompt: str, steps: int = 100, guidance: float = 3.0,
                output_path: str = "output.wav", seed: Optional[int] = None) -> str:
        assert self.tango is not None, "call setup() first"
        if seed is not None:
            return super().predict(prompt, steps, guidance, output_path, seed)
        req = _Request(prompt, steps, guidance, output_path, seed)
        with self._lock:
            # close() sets _shutdown under this lock: either it is seen here,
            # or the request is queued before close() drains and gets its error
            if self._shutdown:
                raise RuntimeError("BatchingPredictor closed")
            self._queue.append(req)
            self._lock.notify_all()
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def _serve_loop(self):
        while True:
            with self._lock:
                while not self._queue and not self._shutdown:
                    self._lock.wait()
                if self._shutdown:
                    return
                # the batching window: a notify wakes wait() early, so wait on
                # until the window closes or the batch is full
                deadline = time.monotonic() + self.max_wait_ms / 1000.0
                while len(self._queue) < self.max_batch and not self._shutdown:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._lock.wait(remaining)
                if self._shutdown:
                    return
                key = (self._queue[0].steps, self._queue[0].guidance)
                group = [r for r in self._queue if (r.steps, r.guidance) == key]
                group = group[: self.max_batch]
                for r in group:
                    self._queue.remove(r)
            try:
                self.predict_batch([r.prompt for r in group], steps=key[0], guidance=key[1],
                                   output_paths=[r.output_path for r in group],
                                   batch_size=self.max_batch)
                for r in group:
                    r.result = r.output_path
            except Exception as e:  # every waiter of the batch gets the error
                for r in group:
                    r.error = e
            finally:
                for r in group:
                    r.done.set()


def serve_http(predictor, port: int, host: str = "127.0.0.1"):
    """A stdlib HTTP server over a (Batching)Predictor; returns the server
    (call .serve_forever(), as the CLI does, and .shutdown()).

      GET  /healthz  -> 200 "ok"
      POST /generate {"prompt": ..., "steps": 100, "guidance": 3.0, "seed": null}
                     -> 200 audio/wav; 400 for a bad body; 500 when the
                        generation fails (the server lives on)

    ThreadingHTTPServer serves each request on its own thread, so concurrent
    requests reach BatchingPredictor together and coalesce."""
    import json as json_mod
    import tempfile
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str = "text/plain"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok")
            else:
                self._send(404, b"not found")

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, b"not found")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json_mod.loads(self.rfile.read(n) or b"{}")
                prompt = req.get("prompt")
                if not prompt or not isinstance(prompt, str):
                    self._send(400, b'{"error": "missing prompt"}', "application/json")
                    return
                with tempfile.TemporaryDirectory() as td:
                    path = predictor.predict(
                        prompt, steps=int(req.get("steps", 100)),
                        guidance=float(req.get("guidance", 3.0)),
                        output_path=os.path.join(td, "out.wav"),
                        seed=int(req["seed"]) if req.get("seed") is not None else None)
                    with open(path, "rb") as f:
                        wav = f.read()
                self._send(200, wav, "audio/wav")
            except (ValueError, TypeError, AttributeError, json_mod.JSONDecodeError) as e:
                self._send(400, json_mod.dumps({"error": str(e)}).encode(), "application/json")
            except Exception as e:  # a generation failure: 500, and the server lives on
                self._send(500, json_mod.dumps({"error": str(e)}).encode(), "application/json")

        def log_message(self, fmt, *args):  # no request log
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    p = argparse.ArgumentParser(description="tango_tpu_torch generation CLI")
    p.add_argument("--model", type=str, default="declare-lab/tango",
                   help="reference-format snapshot directory")
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--listen", type=int, default=None, metavar="PORT",
                   help="serve HTTP on this port instead of one-shot generation "
                        "(POST /generate, GET /healthz; concurrent requests batch)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--guidance", type=float, default=3.0)
    p.add_argument("--samples", type=int, default=1)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--output", type=str, default="output.wav")
    p.add_argument("--music", action="store_true",
                   help="the Mustango pipeline (--model a Mustango snapshot)")
    p.add_argument("--quant", type=str, default=None, choices=("conv", "dense", "all"),
                   help="int8 W8A8 UNet serving mode")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card unless given (e.g. cpu)")
    args = p.parse_args(argv)
    if args.samples < 1:
        p.error("--samples must be >= 1")
    if args.listen is None and args.prompt is None:
        p.error("--prompt is required (or --listen PORT for server mode)")

    if args.listen is not None:
        predictor = BatchingPredictor()
        predictor.setup(args.model, quant=args.quant, music=args.music, device=args.device)
        server = serve_http(predictor, args.listen)
        print(f"serving on :{args.listen} (POST /generate, GET /healthz)", flush=True)
        try:
            server.serve_forever()
        finally:
            predictor.close()
        return

    from tango_tpu_torch.audio.wav import write_wav

    t0 = time.time()
    if args.music:
        wavs = _music_cli(args)
    else:
        from tango_tpu_torch import pipeline

        model = pipeline.Tango(args.model, quant=args.quant, device=args.device)
        wavs = model.generate(args.prompt, steps=args.steps, guidance=args.guidance,
                              samples=args.samples, seed=args.seed)
        if args.samples == 1:
            wavs = [wavs]
    if args.samples == 1:
        write_wav(args.output, wavs[0], 16000)
        print(f"wrote {args.output} in {time.time() - t0:.1f}s")
        return
    # every sample is written: output.wav, output_1.wav, ...
    base, ext = os.path.splitext(args.output)
    for i, w in enumerate(wavs[: args.samples]):
        write_wav(args.output if i == 0 else f"{base}_{i}{ext}", w, 16000)
    print(f"wrote {args.samples} samples at {base}*{ext} in {time.time() - t0:.1f}s")


def _music_cli(args) -> list:
    """The CLI's Mustango generation: the (deterministic) predictors run once
    for the prompt; several samples ride one batch of 4 with those features,
    a row's noise from its own generator."""
    from tango_tpu_torch import pipeline_music

    model = pipeline_music.Mustango(args.model, quant=args.quant, device=args.device)
    beats = chords = chords_times = None
    if model.predictor is not None:
        beats, chords, chords_times = model.predictor.generate(args.prompt)
    if args.samples == 1:
        return [model.generate(args.prompt, steps=args.steps, guidance=args.guidance,
                               beats=beats, chords=chords, chords_times=chords_times,
                               seed=args.seed)]
    n = args.samples
    rows = (None,) * 3 if beats is None else ([beats] * n, [chords] * n, [chords_times] * n)
    return model.generate_for_batch([args.prompt] * n, steps=args.steps, guidance=args.guidance,
                                    batch_size=4, beats=rows[0], chords=rows[1],
                                    chords_times=rows[2], seed=args.seed)


if __name__ == "__main__":
    main()

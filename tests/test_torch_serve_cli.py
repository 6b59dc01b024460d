"""The port's serving layer (tango_tpu_torch/serve.py): the cases of
tests/test_serve_cli.py on a stub pipeline (Mustango's on a stub Mustango),
and the predictors, the HTTP server and the CLI on the reference-format tiny
snapshots (Tango's and Mustango's) with device="cpu" (latents cut to 8 frames, as in
tests/test_torch_inference_cli.py). Every wait on a thread or a request has
its own timeout, so a hung server fails its test instead of the suite."""

import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import tango_tpu_torch.pipeline as pipeline_mod
import tango_tpu_torch.pipeline_music as music_mod
from tango_tpu_torch import serve
from tango_tpu_torch.serve import BatchingPredictor, Predictor, serve_http
from tango_tpu_torch.tokenizer import WordHashTokenizer

from tests.conftest import GOLDEN

torch.set_num_threads(1)

SNAP = str(GOLDEN / "snapshot_tiny")
MSNAP = str(GOLDEN / "snapshot_tiny_mustango")
SHORT_T = 8
WAV_LEN = 2 * SHORT_T * 160 + 32  # the tiny VAE doubles T; HiFi-GAN x160, +32 edge
WAIT_S = 60


class _StubTango:
    def __init__(self, *a, **kw):
        self.kw = kw
        self.calls = []
        self.batch_calls = []

    def generate(self, prompt, steps=100, guidance=3.0, samples=1, disable_progress=True,
                 seed=None, **kw):
        self.calls.append((prompt, steps, guidance, samples, seed))
        wav = (np.sin(np.linspace(0, 100, 16000)) * 20000).astype(np.int16)
        return [wav] * samples if samples > 1 else wav

    def generate_for_batch(self, prompts, steps=100, guidance=3.0, samples=1, batch_size=8,
                           disable_progress=True, seed=None):
        self.batch_calls.append((list(prompts), steps, guidance, batch_size, seed))
        wav = (np.sin(np.linspace(0, 100, 16000)) * 20000).astype(np.int16)
        return [wav.copy() for _ in prompts]


@pytest.fixture
def stub(monkeypatch):
    made = {}

    def factory(name, **kw):
        made["t"] = _StubTango(name, **kw)
        made["kw"] = kw
        return made["t"]

    monkeypatch.setattr(pipeline_mod, "Tango", factory)
    return made


@pytest.fixture
def tiny(monkeypatch):
    """Every Tango that serve builds: the real one from snapshot_tiny, its
    latents cut to SHORT_T frames."""
    made = []
    real = pipeline_mod.Tango

    def short(name_or_path, **kw):
        t = real(name_or_path, tokenizer=WordHashTokenizer(128), **kw)
        t.model.latent_t_size = SHORT_T
        made.append((kw, t))
        return t

    monkeypatch.setattr(pipeline_mod, "Tango", short)
    return made


def _join(threads):
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads), "a request hung"


# ------------------------------------------------------------ on the stub

def test_serve_cli_writes_wav(tmp_path, stub):
    out = str(tmp_path / "o.wav")
    serve.main(["--model", "x", "--prompt", "a dog barks", "--steps", "7", "--guidance", "2.5",
                "--seed", "4", "--output", out, "--device", "cpu"])
    assert os.path.exists(out)
    assert stub["t"].calls == [("a dog barks", 7, 2.5, 1, 4)]
    assert stub["kw"]["device"] == "cpu"


def test_serve_cli_quant_flag(tmp_path, stub):
    out = str(tmp_path / "q.wav")
    serve.main(["--model", "x", "--prompt", "p", "--quant", "conv", "--steps", "2",
                "--output", out])
    assert stub["kw"].get("quant") == "conv" and stub["kw"].get("device") is None
    assert os.path.exists(out)


def test_serve_cli_samples_write_every_file(tmp_path, stub):
    out = str(tmp_path / "s.wav")
    serve.main(["--model", "x", "--prompt", "p", "--samples", "3", "--steps", "2",
                "--output", out])
    assert [os.path.exists(tmp_path / n) for n in ("s.wav", "s_1.wav", "s_2.wav")] == [True] * 3
    assert stub["t"].calls == [("p", 2, 3.0, 3, None)]


class _StubMustango(_StubTango):
    """Mustango-shaped stub: records the features too."""

    def generate(self, prompt, steps=100, guidance=3.0, samples=1, disable_progress=True,
                 beats=None, chords=None, chords_times=None, seed=None):
        self.calls.append((prompt, steps, beats, chords, chords_times, seed))
        return (np.sin(np.linspace(0, 100, 16000)) * 20000).astype(np.int16)

    def generate_for_batch(self, prompts, steps=100, guidance=3.0, batch_size=4, beats=None,
                           chords=None, chords_times=None, seed=None, disable_progress=True):
        self.batch_calls.append((list(prompts), steps, batch_size, beats, seed))
        wav = (np.sin(np.linspace(0, 100, 16000)) * 20000).astype(np.int16)
        return [wav.copy() for _ in prompts]


@pytest.fixture
def stub_music(monkeypatch):
    made = {}

    def factory(name, **kw):
        made["m"] = _StubMustango(name, **kw)
        made["kw"] = kw
        return made["m"]

    monkeypatch.setattr(music_mod, "Mustango", factory)
    return made


def test_music_raises_naming_its_queue_item(tmp_path, stub, stub_music):
    """--music (queue A #7) no longer raises: it serves. BatchingPredictor's
    setup builds Mustango, warms the single and the batched path with empty
    features (the predictors do not run), and concurrent requests coalesce
    into one padded music batch (tests/test_serve_cli.py:158-215)."""
    p = BatchingPredictor(max_batch=4, max_wait_ms=200)
    p.setup(model="stub-music", music=True, quant="conv", device="cpu")
    m = stub_music["m"]
    assert "t" not in stub and stub_music["kw"] == {"quant": "conv", "device": "cpu"}
    assert m.calls[0][0] == "warmup" and m.calls[0][2:5] == ([[], []], [], [])
    warm_prompts, _, warm_bs, warm_beats, _ = m.batch_calls[0]
    assert warm_prompts == ["warmup"] * 4 and warm_beats == [[[], []]] * 4
    n_warm = len(m.batch_calls)
    results = {}

    def call(i):
        results[i] = p.predict(f"song {i}", steps=3, output_path=str(tmp_path / f"m{i}.wav"))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for th in threads:
        th.start()
    _join(threads)
    assert len(results) == 3 and all(os.path.exists(v) for v in results.values())
    served = m.batch_calls[n_warm:]
    assert len(served) == 1 and len(served[0][0]) == 4 and served[0][3] is None
    p.close()


def test_music_cli_runs_the_predictor_once(tmp_path, stub_music):
    """The CLI's --music branch: with a predictor its features are computed
    once and passed to generate (one sample) or to every row of one batch
    of 4 (several samples)."""
    feats = ([[[0.5, 1.0], [1.0, 2.0]]], ["Gm"], [0.4])

    class Pred:
        def __init__(self):
            self.prompts = []

        def generate(self, prompt):
            self.prompts.append(prompt)
            return feats

    def with_predictor(name, **kw):
        m = _StubMustango(name, **kw)
        m.predictor = Pred()
        stub_music["m"] = m
        return m

    music_mod.Mustango = with_predictor
    out = str(tmp_path / "m.wav")
    serve.main(["--music", "--model", "x", "--prompt", "jazz", "--steps", "2", "--seed", "3",
                "--output", out, "--device", "cpu"])
    m = stub_music["m"]
    assert os.path.exists(out) and m.predictor.prompts == ["jazz"]
    assert m.calls == [("jazz", 2, *feats, 3)]
    serve.main(["--music", "--model", "x", "--prompt", "jazz", "--samples", "3", "--steps", "2",
                "--output", out])
    m = stub_music["m"]
    prompts, steps, bs, beats, seed = m.batch_calls[0]
    assert prompts == ["jazz"] * 3 and bs == 4 and beats == [feats[0]] * 3
    assert all(os.path.exists(tmp_path / n) for n in ("m.wav", "m_1.wav", "m_2.wav"))


def test_music_on_snapshot_tiny_mustango(tmp_path, monkeypatch):
    """`--music` end to end on the tiny Mustango snapshot on the CPU, latents
    cut to 8 frames, its (absent) predictor replaced by fixed features: the
    one-shot CLI writes a 16 kHz int16 WAV, and a seeded Predictor request
    equals `generate` at that seed with the predictor's features."""
    real = music_mod.Mustango
    made = []
    feats = ([[[0.5, 1.0, 1.5], [1.0, 2.0, 1.0]]], ["Gm", "F7"], [0.4, 2.2])

    def short(name_or_path, **kw):
        m = real(name_or_path, tokenizer=WordHashTokenizer(64), **kw)
        m.model.latent_t_size = SHORT_T
        m.predictor = music_mod.MusicFeaturePredictor(
            beats_fn=lambda p: (np.array([0.0, 3.0]), np.full(3, 0.5, np.float32)),
            chords_fn=lambda c: "Gm at 0.4 n F7 at 2.2")
        made.append(m)
        return m

    monkeypatch.setattr(music_mod, "Mustango", short)
    out = str(tmp_path / "music.wav")
    serve.main(["--music", "--model", MSNAP, "--prompt", "a jazzy tune", "--steps", "2",
                "--seed", "0", "--output", out, "--device", "cpu"])
    rate, wav = wavfile.read(out)
    assert rate == 16000 and wav.dtype == np.int16 and wav.shape == (WAV_LEN,)
    assert np.abs(wav.astype(np.int32)).max() > 0
    p = Predictor()
    p.setup(model=MSNAP, music=True, device="cpu")
    assert made[-1].device.type == "cpu" and p.music
    path = p.predict("a jazzy tune", steps=2, output_path=str(tmp_path / "p.wav"), seed=0)
    assert made[-1].predictor.generate("a jazzy tune") == feats
    want = made[-1].generate("a jazzy tune", steps=2, seed=0, beats=feats[0], chords=feats[1],
                             chords_times=feats[2])
    np.testing.assert_array_equal(wavfile.read(path)[1], want)
    np.testing.assert_array_equal(wav, want)


def test_predictor_lifecycle(tmp_path, stub):
    p = Predictor()
    with pytest.raises(AssertionError):
        p.predict("too early")
    p.setup(model="stub", device="cpu")
    # the warm-up: one 100-step generate
    assert stub["t"].calls == [("warmup", 100, 3.0, 1, None)] and stub["kw"]["device"] == "cpu"
    out = p.predict("hello", steps=3, output_path=str(tmp_path / "p.wav"))
    assert os.path.exists(out)


def test_predict_batch_pads_to_power_of_two(tmp_path, stub):
    p = Predictor()
    p.setup(model="stub")
    paths = [str(tmp_path / f"b{i}.wav") for i in range(3)]
    out = p.predict_batch(["a", "b", "c"], steps=3, output_paths=paths)
    assert out == paths and all(os.path.exists(x) for x in paths)
    prompts, steps, guidance, bs, seed = stub["t"].batch_calls[-1]
    assert prompts == ["a", "b", "c", "a"] and bs == 4
    with pytest.raises(AssertionError, match="power of 2"):
        p.predict_batch(["a"], batch_size=3)


def test_predict_batch_empty_returns_empty(stub):
    p = Predictor()
    p.setup(model="stub")
    assert p.predict_batch([]) == []


def test_batching_predictor_coalesces_concurrent_requests(tmp_path, stub):
    """3 concurrent unseeded predict() calls share one padded batch-4
    generation; a seeded call is served alone."""
    p = BatchingPredictor(max_batch=4, max_wait_ms=200)
    p.setup(model="stub")
    # the warm-ups: one 100-step generate, then one batch-4 generate_for_batch
    assert stub["t"].batch_calls == [(["warmup"] * 4, 100, 3.0, 4, None)]
    n_warm = len(stub["t"].batch_calls)
    results = {}

    def call(i):
        results[i] = p.predict(f"req {i}", steps=3, output_path=str(tmp_path / f"c{i}.wav"))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    _join(threads)
    assert len(results) == 3 and all(os.path.exists(v) for v in results.values())
    served = stub["t"].batch_calls[n_warm:]
    assert len(served) == 1, served
    assert len(served[0][0]) == 4
    out = p.predict("seeded", steps=3, seed=7, output_path=str(tmp_path / "s.wav"))
    assert os.path.exists(out)
    assert stub["t"].calls[-1] == ("seeded", 3, 3.0, 1, 7)
    assert len(stub["t"].batch_calls[n_warm:]) == 1
    p.close()


def test_batching_predictor_groups_by_steps_and_guidance(tmp_path, stub):
    """Requests that differ in (steps, guidance) do not share a batch."""
    p = BatchingPredictor(max_batch=4, max_wait_ms=300)
    p.setup(model="stub")
    n_warm = len(stub["t"].batch_calls)
    threads = [threading.Thread(target=p.predict, args=(f"r{i}", 3 if i < 2 else 5),
                                kwargs={"output_path": str(tmp_path / f"g{i}.wav")})
               for i in range(4)]
    for t in threads:
        t.start()
    _join(threads)
    served = sorted((c[1], c[0][:2]) for c in stub["t"].batch_calls[n_warm:])
    assert [s[0] for s in served] == [3, 5]
    p.close()


def test_batching_predictor_predict_after_close_raises(tmp_path, stub):
    p = BatchingPredictor(max_batch=4, max_wait_ms=10)
    p.setup(model="stub")
    p.close()
    with pytest.raises(RuntimeError, match="closed"):
        p.predict("late", steps=3, output_path=str(tmp_path / "late.wav"))


def test_close_fails_pending_requests(tmp_path, stub):
    """A request queued but not yet taken by the worker gets close()'s error."""
    p = BatchingPredictor(max_batch=4, max_wait_ms=10)
    p.setup(model="stub")
    p.close()  # the worker is gone: what is queued now stays pending
    p._shutdown = False  # reopen the queue only, to put a request in it
    errors = []

    def call():
        try:
            p.predict("pending", steps=3, output_path=str(tmp_path / "x.wav"))
        except RuntimeError as e:
            errors.append(str(e))

    t = threading.Thread(target=call)
    t.start()
    for _ in range(1000):
        with p._lock:
            if p._queue:
                break
        t.join(timeout=0.01)
    p.close()
    _join([t])
    assert errors == ["BatchingPredictor closed"]


def _post(port, body, timeout=WAIT_S):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _server(p):
    server = serve_http(p, 0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, server.server_address[1]


def test_http_server_end_to_end(stub):
    """Concurrent POST /generate requests return WAV bytes and coalesce into
    one padded batch; /healthz, 404, 400 for bad bodies, 500 for a failing
    generation with the server alive after it."""
    p = BatchingPredictor(max_batch=4, max_wait_ms=300)
    p.setup(model="stub")
    n_warm = len(stub["t"].batch_calls)
    server, port = _server(p)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=WAIT_S) as r:
            assert r.status == 200 and r.read() == b"ok"
        results = {}

        def post(i):
            results[i] = _post(port, json.dumps({"prompt": f"clip {i}", "steps": 100}).encode())

        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        _join(threads)
        assert len(results) == 3
        for status, ctype, body in results.values():
            assert status == 200 and ctype == "audio/wav"
            assert body[:4] == b"RIFF" and len(body) > 1000
        served = stub["t"].batch_calls[n_warm:]
        assert len(served) == 1 and len(served[0][0]) == 4

        assert _post(port, b"{}")[0] == 400
        assert _post(port, b"not json")[0] == 400
        assert _post(port, json.dumps({"prompt": "x", "steps": "many"}).encode())[0] == 400
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=WAIT_S)
            raise AssertionError("expected 404")
        except urllib.error.HTTPError as e:
            assert e.code == 404

        def boom(*a, **kw):
            raise RuntimeError("device lost")

        stub["t"].generate = boom
        status, _, body = _post(port, json.dumps({"prompt": "x", "seed": 1}).encode())
        assert status == 500 and b"device lost" in body
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=WAIT_S) as r:
            assert r.status == 200
    finally:
        server.shutdown()
        server.server_close()
        p.close()


# ------------------------------------------------------ on snapshot_tiny

def test_http_on_snapshot_tiny(tiny):
    """The batching server on the tiny snapshot on the CPU: 3 concurrent
    unseeded requests ride one generate_for_batch of batch 4, and a seeded
    request's WAV equals `generate` at that seed, sample for sample."""
    p = BatchingPredictor(max_batch=4, max_wait_ms=500)
    p.setup(model=SNAP, device="cpu")
    (kw, tango), = tiny
    assert kw == {"quant": None, "device": "cpu"} and tango.device.type == "cpu"
    batches = []
    real = p.predict_batch

    def spy(prompts, **kw):
        batches.append(list(prompts))
        return real(prompts, **kw)

    p.predict_batch = spy
    server, port = _server(p)
    try:
        results = {}

        def post(i):
            results[i] = _post(port, json.dumps({"prompt": f"clip {i}", "steps": 2}).encode())

        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        _join(threads)
        assert len(batches) == 1 and len(batches[0]) == 3, batches
        for status, ctype, body in results.values():
            assert status == 200 and ctype == "audio/wav"
            sr, wav = wavfile.read(io.BytesIO(body))
            assert sr == 16000 and wav.dtype == np.int16 and wav.shape == (WAV_LEN,)
            assert np.abs(wav.astype(np.int32)).max() > 0

        status, _, body = _post(port, json.dumps({"prompt": "a dog barks", "steps": 2,
                                                  "seed": 5}).encode())
        assert status == 200 and len(batches) == 1
        sr, got = wavfile.read(io.BytesIO(body))
        want = tango.generate("a dog barks", steps=2, seed=5)
        assert sr == 16000 and got.dtype == np.int16
        np.testing.assert_array_equal(got, want)
    finally:
        server.shutdown()
        server.server_close()
        p.close()


def test_cli_on_snapshot_tiny(tmp_path, tiny):
    out = str(tmp_path / "out.wav")
    serve.main(["--model", SNAP, "--prompt", "a dog barks", "--steps", "2", "--seed", "3",
                "--samples", "2", "--output", out, "--device", "cpu"])
    (kw, tango), = tiny
    assert kw["device"] == "cpu"
    wavs = tango.generate("a dog barks", steps=2, samples=2, seed=3)

    for i, name in enumerate(("out.wav", "out_1.wav")):
        sr, got = wavfile.read(str(tmp_path / name))
        assert sr == 16000 and got.shape == (WAV_LEN,)
        np.testing.assert_array_equal(got, wavs[i])


def test_not_a_directory_raises():
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        Predictor().setup(model="declare-lab/tango", device="cpu")

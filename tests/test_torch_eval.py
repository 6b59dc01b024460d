"""The port's objective evaluation (tango_tpu_torch/eval) against the JAX
package's on the CPU and against the reference goldens, at the JAX tests'
tolerances (tests/test_eval.py, tests/test_eval_composition.py).

The metrics and the Geometry Score are numpy in both packages: the same
inputs and seeds give the same numbers. NDB's k-means is the port's own
(the JAX package uses sklearn's KMeans): it is held to the golden exactly and
to JAX's calculate_ndb on the golden's well-separated blobs. Cnn14 and
VGGish are the full-width nets; their converters are held bit-equal to
`from_jax_params` of JAX's. The evaluator runs Cnn14 and VGGish with seeded
random full-width weights (the eval_composition golden's recipe); its
extraction batch is cut to fit the CPU, which changes no row's numbers (the
nets are per-sample, the padding rows are dropped)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu.eval import evaluator as jevaluator
from tango_tpu.eval import gs as jgs
from tango_tpu.eval import metrics as JM
from tango_tpu.eval import panns as jpanns
from tango_tpu.eval import vggish as jvggish
from tango_tpu_torch.audio.wav import write_wav
from tango_tpu_torch.eval import evaluator, gs
from tango_tpu_torch.eval import metrics as M
from tango_tpu_torch.eval.__main__ import main as eval_main
from tango_tpu_torch.eval.panns import Cnn14, convert_cnn14, logmel_frontend
from tango_tpu_torch.eval.vggish import VGGish, convert_vggish, waveform_to_examples
from tango_tpu_torch.utils.convert import from_jax_params

from tests._torch_helpers import write_extractor_ckpts
from tests.conftest import GOLDEN, load_golden
from tests.test_eval_composition import TOL

torch.set_num_threads(1)

RESULT_KEYS = {"frechet_distance", "frechet_audio_distance", "kl_sigmoid", "kl_softmax", "lsd",
               "psnr", "ssim", "ssim_stft", "is_mean", "is_std", "kid_mean", "kid_std"}


def _featdicts(g):
    f1 = {"2048": g["f1_2048"], "logits": g["f1_logits"],
          "file_path_": [f"/a/x{i}.wav" for i in range(len(g["f1_2048"]))]}
    f2 = {"2048": g["f2_2048"], "logits": g["f2_logits"],
          "file_path_": [f"/b/x{i}.wav" for i in range(len(g["f2_2048"]))]}
    return f1, f2


# name -> (call on (module, f1, f2), {result key: (golden key, rtol)}), as tests/test_eval.py
METRICS = {
    "kl": (lambda m, f1, f2: m.calculate_kl(f1, f2, "logits", True)[0],
           {"kullback_leibler_divergence_softmax": ("kl_softmax", 1e-4),
            "kullback_leibler_divergence_sigmoid": ("kl_sigmoid", 1e-4)}),
    "isc": (lambda m, f1, f2: m.calculate_isc(f1, "logits", rng_seed=2020, samples_shuffle=True,
                                              splits=4),
            {"inception_score_mean": ("isc_mean", 1e-5), "inception_score_std": ("isc_std", 1e-4)}),
    "fid": (lambda m, f1, f2: m.calculate_fid(f1, f2, "2048"),
            {"frechet_distance": ("fid", 1e-4)}),
    "kid": (lambda m, f1, f2: m.calculate_kid(f1, f2, "2048", subsets=10, subset_size=12,
                                              rng_seed=2020),
            {"kernel_inception_distance_mean": ("kid_mean", 1e-4),
             "kernel_inception_distance_std": ("kid_std", 1e-3)}),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_golden_and_jax(name):
    g = load_golden("metrics")
    f1, f2 = _featdicts(g)
    call, keys = METRICS[name]
    ours, theirs = call(M, f1, f2), call(JM, f1, f2)
    for key, (gkey, rtol) in keys.items():
        np.testing.assert_allclose(ours[key], g[gkey], rtol=rtol)
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-12)


def test_paired_metrics_match_jax():
    rng = np.random.RandomState(3)
    a = rng.rand(40, 64)
    b = np.clip(a + 0.05 * rng.randn(40, 64), 0, 1)
    assert M.psnr(a, b, 1.0) == JM.psnr(a, b, 1.0)
    assert M.ssim(a, b, 2.0) == JM.ssim(a, b, 2.0)
    w1, w2 = rng.randn(2, 9000)
    assert M.log_spectral_distance(w1, w2) == JM.log_spectral_distance(w1, w2)
    assert M.psnr(a, a) == float("inf") and abs(M.ssim(a, a) - 1.0) < 1e-9


def test_ndb_value_parity_golden():
    """calculate_ndb on the golden's blobs, without sklearn: the golden's NDB
    exactly, JS at rtol 1e-12, the sorted bin proportions at 1e-12."""
    g = np.load(GOLDEN / "ndb.npz")
    res = M.calculate_ndb(g["train"].astype(np.float64), g["query"].astype(np.float64),
                          number_of_bins=int(g["k"]))
    assert res["ndb"] == int(g["ndb"]) == int(np.sum(g["different_bins"]))
    np.testing.assert_allclose(res["js_divergence"], float(g["js"]), rtol=1e-12)
    np.testing.assert_allclose(res["train_props_sorted"], g["train_props_sorted"], atol=1e-12)
    np.testing.assert_allclose(res["query_props_sorted"], g["query_props_sorted"], atol=1e-12)


def test_kmeans_ndb_matches_jax_sklearn_on_blobs():
    """The port's k-means bins the golden's blobs as JAX's sklearn KMeans does."""
    g = np.load(GOLDEN / "ndb.npz")
    train, query = g["train"].astype(np.float64), g["query"].astype(np.float64)
    for seed in (0, 1):
        ours = M.calculate_ndb(train, query, number_of_bins=int(g["k"]), rng_seed=seed)
        theirs = JM.calculate_ndb(train, query, number_of_bins=int(g["k"]), rng_seed=seed)
        assert ours["ndb"] == theirs["ndb"]
        np.testing.assert_allclose(ours["js_divergence"], theirs["js_divergence"], rtol=1e-12)
        for key in ("train_props_sorted", "query_props_sorted"):
            np.testing.assert_allclose(ours[key], theirs[key], atol=1e-12)


def test_ndb_same_vs_shifted():
    rng = np.random.RandomState(0)
    ref = rng.randn(600, 8)
    same = rng.randn(600, 8)
    shifted = rng.randn(600, 8) + 2.5
    same_res = M.calculate_ndb(ref, same, number_of_bins=10)
    shift_res = M.calculate_ndb(ref, shifted, number_of_bins=10)
    assert same_res["ndb"] <= 3
    assert shift_res["ndb"] >= 7
    assert shift_res["js_divergence"] > same_res["js_divergence"]


def test_kmeans_recovers_blobs():
    rng = np.random.RandomState(5)
    centers = rng.randn(4, 3) * 20
    x = np.concatenate([c + rng.randn(50, 3) for c in centers])
    found = M.kmeans(x, 4, rng_seed=1)
    order = [int(np.argmin(((found - c) ** 2).sum(1))) for c in centers]
    assert sorted(order) == [0, 1, 2, 3]
    np.testing.assert_allclose(found[order], [x[i * 50:(i + 1) * 50].mean(0) for i in range(4)],
                               atol=1e-12)


def _circle(n, rng):
    phi = 2 * np.pi * rng.rand(n)
    return np.stack([np.sin(phi), np.cos(phi)], 1) + 0.05 * rng.randn(n, 2)


def test_geometry_score_matches_jax():
    kw = dict(L_0=32, gamma=1 / 8, n=4)
    c = _circle(256, np.random.RandomState(0))
    p = np.random.RandomState(1).rand(256, 2) * 2 - 1
    ours = [gs.rlts(x, seed=s, **kw) for x, s in ((c, 3), (p, 4))]
    theirs = [jgs.rlts(x, seed=s, **kw) for x, s in ((c, 3), (p, 4))]
    for o, t in zip(ours, theirs):
        np.testing.assert_array_equal(o, t)
    assert gs.geom_score(*ours) == jgs.geom_score(*theirs)
    assert ours[0][:, 1].mean() > ours[1][:, 1].mean()  # the circle's one hole


# ---------------------------------------------------------------- Cnn14, VGGish

def _sd(g):
    return {k[4:]: g[k] for k in g.files if k.startswith("sd::")}


def test_cnn14_converter_and_parity():
    g = load_golden("cnn14_tiny")
    sd = _sd(g)
    jparams = jpanns.convert_cnn14(sd)
    ours = convert_cnn14(sd)
    ref = from_jax_params(jparams)
    assert set(ours) == set(ref)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    model = Cnn14(classes_num=11)
    model.load_state_dict(ours)
    logmel = g["logmel"][:, 0]  # (B, T, mel)
    with torch.no_grad():
        out = model(torch.from_numpy(logmel))
    jout = jpanns.Cnn14(classes_num=11).apply({"params": jparams}, logmel)
    for key, gkey in (("2048", "emb"), ("logits", "logits")):
        np.testing.assert_allclose(out[key].numpy(), g[gkey], atol=2e-4, rtol=1e-3)
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]), atol=2e-4, rtol=1e-3)


def test_logmel_frontend_matches_jax():
    wav = np.random.RandomState(1).randn(2, 16000).astype(np.float32) * 0.1
    ours = logmel_frontend(torch.from_numpy(wav)).numpy()
    theirs = np.asarray(jpanns.logmel_frontend(jnp.asarray(wav)))
    assert ours.shape == theirs.shape == (2, 101, 64)
    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=1e-3)


def test_vggish_converter_and_parity():
    g = load_golden("vggish")
    sd = _sd(g)
    jparams = jvggish.convert_vggish(sd)
    ours = convert_vggish(sd)
    ref = from_jax_params(jparams)
    assert set(ours) == set(ref)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    x = np.asarray(g["x"])[:, 0]  # (B, 96, 64)
    full, raw = VGGish(use_activation=True), VGGish()
    full.load_state_dict(ours)
    raw.load_state_dict(ours)
    with torch.no_grad():
        emb, emb_raw = full(torch.from_numpy(x)).numpy(), raw(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(emb, g["emb"], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(np.maximum(emb_raw, 0.0), g["emb"], atol=2e-4, rtol=1e-3)
    assert emb_raw.min() < 0, "the raw FAD embeddings keep negative dims"
    jraw = jvggish.VGGish().apply({"params": jparams}, x)
    np.testing.assert_allclose(emb_raw, np.asarray(jraw), atol=2e-4, rtol=1e-3)


def test_vggish_frontend_matches_jax():
    wav = np.random.RandomState(0).randn(32000).astype(np.float32) * 0.1
    ex = waveform_to_examples(wav, 16000)
    assert ex.shape == (2, 96, 64)
    np.testing.assert_array_equal(ex, jvggish.waveform_to_examples(wav, 16000))
    wav44 = np.random.RandomState(1).randn(44100).astype(np.float32) * 0.1
    np.testing.assert_array_equal(waveform_to_examples(wav44, 44100),
                                  jvggish.waveform_to_examples(wav44, 44100))
    assert waveform_to_examples(wav[:9000]).shape == (0, 96, 64)


# ---------------------------------------------------------------- the evaluator

def test_paired_mel_chain_golden():
    g = load_golden("pairedmel")
    ours = evaluator.EvaluationHelper(16000, device="cpu")._mel_from_wav(g["wav"])
    np.testing.assert_allclose(ours.T, g["mel"], atol=2e-4, rtol=1e-3)
    theirs = jevaluator.EvaluationHelper(16000)._mel_from_wav(g["wav"])
    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=1e-3)
    assert ours.min() < 0.6


def test_loaders_match_jax(tmp_path):
    """WaveDataset, FAD and MelPairedDataset loaders, mono and stereo, at 16
    and 32 kHz, sample for sample against JAX's."""
    t = np.linspace(0, 1, 16000, endpoint=False)
    quiet = (0.05 * np.sin(2 * np.pi * 220 * t) + 0.02).astype(np.float32)
    files = []
    for name, wav, sr in (("m", quiet, 16000), ("s", np.stack([quiet, 0 * quiet], 1), 16000),
                          ("h", np.repeat(quiet, 2), 32000), ("r", quiet[:11025], 22050)):
        files.append(str(tmp_path / f"{name}.wav"))
        write_wav(files[-1], wav, sr)
    for f in files:
        for ours, theirs in ((evaluator._read_wave_dataset, jevaluator._read_wave_dataset),
                             (evaluator._read_fad, jevaluator._read_fad),
                             (evaluator._read_paired, jevaluator._read_paired)):
            np.testing.assert_array_equal(ours(f, 16000), theirs(f, 16000))
    wd = evaluator._read_wave_dataset(files[0], 16000)
    assert len(wd) == 32000 and 0.04 < np.abs(wd).max() < 0.07


@pytest.fixture(scope="module")
def extractor_ckpts(tmp_path_factory):
    return write_extractor_ckpts(str(tmp_path_factory.mktemp("ckpts")))


def _pair_dirs(root, n, seconds, seed):
    gen, ref = root / "gen", root / "ref"
    gen.mkdir()
    ref.mkdir()
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    for i in range(n):
        base = sum(rng.uniform(0.1, 0.3) * np.sin(2 * np.pi * rng.uniform(100, 2000) * t)
                   for _ in range(3))
        write_wav(str(ref / f"output_{i}.wav"), base.astype(np.float32))
        write_wav(str(gen / f"output_{i}.wav"),
                  (base + 0.05 * rng.randn(len(t))).astype(np.float32))
    return str(gen), str(ref)


def test_evaluation_helper_main_matches_jax(tmp_path, extractor_ckpts, monkeypatch):
    """EvaluationHelper.main of both packages on the same two directories
    with the same Cnn14 and VGGish checkpoints: every key within the JAX
    composition test's tolerances (the covariance square roots amplify f32
    differences)."""
    gen, ref = _pair_dirs(tmp_path, 10, 2.0, seed=0)  # 10: one clip for each IS split
    for cls in (evaluator.EvaluationHelper, jevaluator.EvaluationHelper):
        monkeypatch.setattr(cls, "batch_size", 10)
    cnn14, vgg = extractor_ckpts
    ours = evaluator.EvaluationHelper(16000, device="cpu", cnn14_ckpt=cnn14,
                                      vggish_ckpt=vgg).main(gen, ref)
    theirs = jevaluator.EvaluationHelper(16000, cnn14_ckpt=cnn14, vggish_ckpt=vgg).main(gen, ref)
    assert set(ours) == set(theirs) == RESULT_KEYS
    bad = {k: (ours[k], theirs[k]) for k in RESULT_KEYS
           if not (np.isfinite(ours[k]) and abs(ours[k] - theirs[k]) <= TOL[k])}
    assert not bad, bad
    with open(gen + "_evaluation_results.json") as f:
        assert json.load(f) == ours


def test_evaluation_helper_without_extractors_matches_jax(tmp_path):
    """No checkpoints: the paired metrics equal JAX's, the rest NaN; an
    unpaired directory gives the reference's -1."""
    gen, ref = _pair_dirs(tmp_path, 3, 1.5, seed=1)
    ours = evaluator.EvaluationHelper(16000, device="cpu").main(gen, ref)
    theirs = jevaluator.EvaluationHelper(16000).main(gen, ref)
    for k in RESULT_KEYS:
        assert (np.isnan(ours[k]) and np.isnan(theirs[k])) or ours[k] == theirs[k], k
    assert ours["psnr"] > 5 and 0 < ours["ssim"] <= 1 and ours["lsd"] > 0
    os.rename(os.path.join(gen, "output_0.wav"), os.path.join(gen, "other.wav"))
    unpaired = evaluator.EvaluationHelper(16000, device="cpu").main(gen, ref)
    assert unpaired["lsd"] == unpaired["psnr"] == -1


def test_evaluator_composition_golden(tmp_path, extractor_ckpts, monkeypatch):
    """The reference EvaluationHelper.main's result on the eval_composition
    golden's 12 WAV pairs (tests/test_eval_composition.py), at that test's
    tolerances."""
    from scipy.io import wavfile

    g = np.load(GOLDEN / "eval_composition.npz")
    gen, ref = tmp_path / "gen", tmp_path / "ref"
    gen.mkdir()
    ref.mkdir()
    for i in range(12):
        wavfile.write(str(gen / f"output_{i:02d}.wav"), 16000, g[f"gen_{i:02d}"])
        wavfile.write(str(ref / f"output_{i:02d}.wav"), 16000, g[f"ref_{i:02d}"])
    monkeypatch.setattr(evaluator.EvaluationHelper, "batch_size", 1)
    cnn14, vgg = extractor_ckpts
    result = evaluator.EvaluationHelper(16000, device="cpu", cnn14_ckpt=cnn14,
                                        vggish_ckpt=vgg).main(str(gen), str(ref))
    expected = {k[4:]: float(g[k]) for k in g.files if k.startswith("res_")}
    assert set(result) == set(expected)
    bad = {k: (result[k], v) for k, v in expected.items()
           if not (np.isfinite(result[k]) and abs(result[k] - v) <= TOL[k])}
    assert not bad, bad


def test_eval_cli(tmp_path, capsys):
    gen, ref = _pair_dirs(tmp_path, 2, 2.0, seed=2)
    out = tmp_path / "res.json"
    result = eval_main([gen, ref, "--output", str(out), "--device", "cpu", "--limit_num", "2"])
    assert set(result) == RESULT_KEYS and result["lsd"] > 0
    assert set(json.loads(out.read_text())) == RESULT_KEYS
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["lsd"] == result["lsd"]
    assert os.path.exists(gen + "_evaluation_results.json")


def test_eval_default_device_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluator.EvaluationHelper(16000)

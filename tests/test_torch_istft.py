"""The port's inverse STFT and Griffin-Lim (tango_tpu_torch/audio/stft.py)
against JAX's (tango_tpu/audio/stft.py:186-240) on the same inputs, and the
round-trip and convergence cases of tests/test_audio.py on the port alone.

Tolerances: `stft_complex` and `istft` are one FFT and an overlap-add in f32
on both sides, held at 1e-5 absolute on signals of amplitude 0.5 (a few f32
ulps after a 1024-point FFT). Griffin-Lim is fed JAX's initial phase
(`jax.random.uniform(PRNGKey(0), ..., -pi, pi)`) and runs 8 rounds: phases
are re-derived each round from the last signal, so f32 differences in the
FFTs compound; the signals are held at 1e-4 absolute (amplitude 0.5) and the
relative L2 at 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu.audio import stft as jstft
from tango_tpu_torch.audio.stft import griffin_lim, hann_window_periodic, istft, stft_complex

torch.set_num_threads(1)


def _signal(n=16000, seed=0):
    t = np.linspace(0, n / 16000, n, endpoint=False)
    rng = np.random.RandomState(seed)
    y = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1313 * t)
    return (y + 0.01 * rng.randn(n))[None].astype(np.float32)


@pytest.mark.parametrize("n_fft,hop", [(1024, 160), (512, 128)])
def test_stft_complex_and_istft_match_jax(n_fft, hop):
    y = _signal()
    jwin = jnp.asarray(hann_window_periodic(n_fft))
    win = torch.from_numpy(hann_window_periodic(n_fft))
    jmag, jphase = jstft.stft_complex(jnp.asarray(y), n_fft, hop, jwin)
    mag, phase = stft_complex(torch.from_numpy(y), n_fft, hop, win)
    np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), atol=1e-4, rtol=1e-5)
    # the same spectrum from both: compare the istft of JAX's magnitude and phase
    jrec = np.asarray(jstft.istft(jmag, jphase, n_fft, hop, jwin))
    rec = istft(torch.from_numpy(np.array(jmag)), torch.from_numpy(np.array(jphase)),
                n_fft, hop, win).numpy()
    assert rec.shape == jrec.shape
    np.testing.assert_allclose(rec, jrec, atol=1e-5)


def test_istft_roundtrip():
    """tests/test_audio.py's round trip: the interior reconstructs."""
    n_fft, hop = 1024, 160
    t = np.linspace(0, 1, 16000, endpoint=False)
    y = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1313 * t)).astype(np.float32)
    window = torch.from_numpy(hann_window_periodic(n_fft))
    mag, phase = stft_complex(torch.from_numpy(y[None]), n_fft, hop, window)
    rec = istft(mag, phase, n_fft, hop, window).numpy()[0]
    n = min(len(rec), len(y))
    err = np.abs(rec[2000: n - 2000] - y[2000: n - 2000]).max()
    assert err < 1e-3, err


def test_griffin_lim_converges():
    """tests/test_audio.py's convergence case: 32 rounds bring the interior
    frames' magnitudes within 0.2 relative L2."""
    n_fft, hop = 512, 128
    t = np.linspace(0, 0.5, 8000, endpoint=False)
    y = torch.from_numpy((0.5 * np.sin(2 * np.pi * 500 * t)).astype(np.float32))[None]
    window = torch.from_numpy(hann_window_periodic(n_fft))
    mag, _ = stft_complex(y, n_fft, hop, window)
    rec = griffin_lim(mag, n_fft, hop, n_iters=32, generator=torch.Generator().manual_seed(0))
    mag2, _ = stft_complex(rec[:, : y.shape[1]], n_fft, hop, window)
    n = min(mag.shape[1], mag2.shape[1])
    a, b = mag[0, 4: n - 4], mag2[0, 4: n - 4]
    rel = float((a - b).norm() / a.norm())
    assert rel < 0.2, rel


def test_griffin_lim_matches_jax():
    n_fft, hop = 512, 128
    y = _signal(8000, seed=1)
    jwin = jnp.asarray(hann_window_periodic(n_fft))
    jmag, _ = jstft.stft_complex(jnp.asarray(y), n_fft, hop, jwin)
    jrec = np.asarray(jstft.griffin_lim(jmag, n_fft, hop, n_iters=8))
    # JAX's initial phase: griffin_lim's default key
    init = np.array(jax.random.uniform(jax.random.PRNGKey(0), jmag.shape, minval=-np.pi,
                                         maxval=np.pi))
    rec = griffin_lim(torch.from_numpy(np.array(jmag)), n_fft, hop, n_iters=8,
                      init_phase=torch.from_numpy(init)).numpy()
    assert rec.shape == jrec.shape
    np.testing.assert_allclose(rec, jrec, atol=1e-4)
    assert np.linalg.norm(rec - jrec) / np.linalg.norm(jrec) < 1e-4
    # the initial phase is drawn in [-pi, pi) when not given
    mag = torch.from_numpy(np.array(jmag))
    a = griffin_lim(mag, n_fft, hop, n_iters=0, generator=torch.Generator().manual_seed(3))
    b = griffin_lim(mag, n_fft, hop, n_iters=0, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == rec.shape

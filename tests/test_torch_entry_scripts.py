"""The port's root entry scripts: examples/demo_torch.py (examples/demo.py's
counterpart) and inference_torch.sh / train_torch.sh (inference.sh's and
train.sh's): the demo's --tiny run on the CPU writes a WAV as long as JAX's
demo's, and every flag a shell script passes is one the port's CLI takes."""

import pathlib
import re
import shlex
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from tango_tpu import configs as JC
from tango_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from tango_tpu.models.vae import AutoencoderKL as JVAE
from tango_tpu_torch.audio.wav import read_wav

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = {"inference_torch.sh": ("tango_tpu_torch.inference", "inference.sh"),
           "train_torch.sh": ("tango_tpu_torch.train.cli", "train.sh")}


def _jax_demo_wav_len() -> int:
    """The length of examples/demo.py --tiny's waveform: its decode (the VAE
    and HiFi-GAN of the demo's configurations on its (1, 8, 4, 8) latents,
    tango_tpu/pipeline.py's `_decode_fn`) traced by jax.eval_shape, without
    computing it."""
    k = jax.random.PRNGKey(0)
    vae = JVAE(JC.VAEConfig(embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2), num_res_blocks=1))
    voc = JHiFiGAN(JC.HiFiGANConfig(num_mels=8, upsample_initial_channel=32))

    def decode(z):
        vp = vae.init(k, jnp.zeros((1, 16, 8, 1)), k)
        mel = vae.apply(vp, z, method=vae.decode_first_stage)[..., 0]
        return voc.apply(voc.init(k, jnp.zeros((1, 8, 8))), mel)

    return jax.eval_shape(decode, jax.ShapeDtypeStruct((1, 8, 4, 8), jnp.float32)).shape[-1]


def test_demo_tiny_on_cpu_writes_jax_length_wav(tmp_path):
    """`python examples/demo_torch.py --tiny --device cpu` in a fresh
    directory: exit 0, one demo_tiny.wav, 16 kHz, not silent, as long as
    JAX's demo's."""
    out = subprocess.run([sys.executable, str(REPO / "examples" / "demo_torch.py"), "--tiny",
                          "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr
    wav, sr = read_wav(str(tmp_path / "demo_tiny.wav"))
    assert sr == 16000 and wav.ndim == 1 and abs(wav).max() > 0
    assert len(wav) == _jax_demo_wav_len()
    assert "demo_tiny.wav" in out.stdout


def test_demo_has_no_silent_cpu_fallback():
    """Without a card and without --device, the demo stops with an error."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    out = subprocess.run([sys.executable, str(REPO / "examples" / "demo_torch.py"), "--tiny"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "--device cpu" in out.stderr


def test_demo_flags_are_jax_demos():
    """examples/demo.py's flags, each also in the port's demo."""
    flags = lambda p: set(re.findall(r'add_argument\("(--\w+)"', p.read_text()))  # noqa: E731
    jax_flags = flags(REPO / "examples" / "demo.py")
    assert jax_flags == {"--tiny", "--model", "--prompt", "--steps", "--guidance"}
    assert flags(REPO / "examples" / "demo_torch.py") == jax_flags | {"--device"}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_shell_script_parses(script):
    out = subprocess.run(["bash", "-n", str(REPO / script)], capture_output=True, text=True,
                         timeout=30)
    assert out.returncode == 0, out.stderr


def _command(path: pathlib.Path) -> list:
    """The script's `-m <module> <flags...>` command as tokens: continuation
    lines joined, comments skipped, `${VAR:-default}` read as its default,
    "$@" dropped."""
    text = path.read_text().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if " -m tango_tpu" in ln and not ln.lstrip().startswith("#"))
    line = re.sub(r"\$\{\w+:-([^}]*)\}", r"\1", line)
    tokens = [t for t in shlex.split(line) if t != "$@"]
    return tokens[tokens.index("-m") + 1:]


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_shell_script_flags_parse_in_the_port_cli(script):
    """The port's script runs the port's CLI, every flag it passes is one
    that CLI's parse_args takes, and it passes the pre-port script's flags."""
    import importlib

    module, jax_script = SCRIPTS[script]
    cmd = _command(REPO / script)
    assert cmd[0] == module
    args = importlib.import_module(module).parse_args(cmd[1:])
    assert args.device is None  # the card, unless the caller appends --device
    jax_cmd = _command(REPO / jax_script)
    assert jax_cmd[0] == module.replace("tango_tpu_torch", "tango_tpu")
    assert cmd[1:] == jax_cmd[1:]

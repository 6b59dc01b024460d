"""tango_tpu_torch walk-through: the PyTorch port's counterpart of
examples/demo.py, with the same flags.

Run with a reference-format snapshot directory for real audio, or with
--tiny for a smoke run on dwarf random weights (no downloads, no files):

    python examples/demo_torch.py --tiny
    python examples/demo_torch.py --model /path/to/tango-snapshot --prompt "..."

Runs on the CUDA card; `--device cpu` runs it on the CPU. Without a card and
without `--device`, it stops with an error instead of falling back.
"""

import argparse
import os
import sys
import time

# the repository root, so that the port imports from a checkout without an install
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tiny_demo(device: str):
    """End-to-end generation with dwarf random models (the wiring of
    examples/demo.py's --tiny: the same configurations, 8 latent frames, 5
    steps), built through the port's modules by Tango.from_components."""
    from tango_tpu_torch import configs as C
    from tango_tpu_torch.audio.wav import write_wav
    from tango_tpu_torch.pipeline import Tango
    from tango_tpu_torch.tokenizer import WordHashTokenizer

    unet_cfg = C.UNetConfig(
        in_channels=8, out_channels=8,
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
        block_out_channels=(32, 64), layers_per_block=1,
        cross_attention_dim=16, attention_head_dim=(2, 4), norm_num_groups=8,
    )
    vae_cfg = C.VAEConfig(embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2), num_res_blocks=1)
    t5_cfg = C.T5Config(vocab_size=128, d_model=16, d_kv=4, d_ff=32, num_layers=2, num_heads=4)
    hifi_cfg = C.HiFiGANConfig(num_mels=8, upsample_initial_channel=32)

    tango = Tango.from_components(
        unet_config=unet_cfg, vae_config=vae_cfg, t5_config=t5_cfg, hifigan_config=hifi_cfg,
        tokenizer=WordHashTokenizer(vocab_size=128), latent_t_size=8, latent_f_size=4,
        device=device, init_seed=0)
    t0 = time.time()
    wav = tango.generate("an audience cheering and clapping", steps=5, guidance=3.0, seed=0)
    write_wav("demo_tiny.wav", wav, 16000)
    print(f"tiny demo: wrote demo_tiny.wav ({wav.shape[0]/16000:.2f}s) on {device} "
          f"in {time.time()-t0:.1f}s")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--model", type=str, default="declare-lab/tango",
                   help="a reference-format snapshot directory (the port downloads nothing)")
    p.add_argument("--prompt", type=str, default="an audience cheering and clapping")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--guidance", type=float, default=3.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CUDA card unless given (e.g. cpu)")
    args = p.parse_args(argv)

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device: pass --device cpu to run on the CPU")
    if args.tiny:
        tiny_demo(args.device)
        return
    from tango_tpu_torch.audio.wav import write_wav
    from tango_tpu_torch.pipeline import Tango

    tango = Tango(args.model, device=args.device)
    wav = tango.generate(args.prompt, steps=args.steps, guidance=args.guidance)
    write_wav("output.wav", wav, 16000)
    print("wrote output.wav")


if __name__ == "__main__":
    main()

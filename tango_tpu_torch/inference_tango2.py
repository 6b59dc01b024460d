"""Tango 2's inference with the CLAP score: port of tango_tpu/inference_tango2.py.

    python -m tango_tpu_torch.inference_tango2 --model <snapshot_dir> \
        --test_file data/test_audiocaps_subset.json \
        --clap_ckpt <laion-clap .pt> [--reference_dir refs/ --cnn14_ckpt ... \
        --vggish_ckpt ...] [--device cpu]

Generates the manifest's prompts (tango2/inference.py) into `output_{i}.wav`,
scores them with CLAP (the mean cosine between each clip and its prompt,
tango2/inference.py:21-46) and, with --reference_dir, the objective
evaluation; appends one record to `summary.jsonl` in the working directory.
Runs on the card unless --device names another. Both tokenizers are the
caller's (`main(argv, tokenizer=, clap_tokenizer=)`): FLAN-T5's falls back to
WordHashTokenizer, CLAP's RoBERTa one to WordHashTokenizer with RoBERTa's
special ids, each with a warning; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import warnings

from tango_tpu_torch.models.clap import ROBERTA_BASE
from tango_tpu_torch.models.htsat import HTSAT_TINY


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tango2 inference + CLAP score")
    p.add_argument("--model", type=str, required=True, help="snapshot directory")
    p.add_argument("--test_file", type=str, required=True)
    p.add_argument("--text_key", type=str, default="captions")
    p.add_argument("--reference_dir", "--test_references", dest="reference_dir",
                   type=str, default=None,
                   help="ground-truth wav dir (the reference --test_references)")
    p.add_argument("--unet_ckpt", type=str, default=None,
                   help="natively trained (DPO) UNet checkpoint directory run over --model's "
                        "frozen components")
    p.add_argument("--cnn14_ckpt", type=str, default=None)
    p.add_argument("--vggish_ckpt", type=str, default=None)
    p.add_argument("--clap_ckpt", type=str, default=None,
                   help="LAION-CLAP checkpoint (HTSAT-tiny + roberta) for the CLAP score")
    p.add_argument("--num_steps", type=int, default=200)
    p.add_argument("--guidance", type=float, default=3.0)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_test_instances", type=int, default=-1)
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--with_tracking", action="store_true",
                   help="log the result dict to wandb if it is importable, else to stdout")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card unless given (e.g. cpu)")
    return p.parse_args(argv)


def load_clap(clap_ckpt: str, tokenizer=None, device=None):
    """A LAION-CLAP `.pt` (RoBERTa-base text tower, HTSAT-tiny audio tower,
    both projections; keys possibly under `module.`) -> models.clap.Clap.
    `tokenizer`: RoBERTa's, or a word hash with RoBERTa's ids, with a warning."""
    from tango_tpu_torch.models.clap import Clap, convert_clap_text
    from tango_tpu_torch.models.htsat import convert_clap_audio
    from tango_tpu_torch.tokenizer import roberta_word_hash
    from tango_tpu_torch.utils.convert import load_torch_bin

    sd = load_torch_bin(clap_ckpt)
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    text_params = convert_clap_text(sd)
    audio_params = convert_clap_audio(sd, HTSAT_TINY)
    del sd
    if tokenizer is None:
        warnings.warn(
            "no CLAP tokenizer given: prompts go through a word hash with RoBERTa's special "
            "ids, not RoBERTa's BPE tokenizer, so CLAP scores are not the released model's; "
            "pass clap_tokenizer= to use the real one", UserWarning, stacklevel=2)
        tokenizer = roberta_word_hash(ROBERTA_BASE.vocab_size)
    return Clap(text_params, audio_params, tokenizer, ROBERTA_BASE, HTSAT_TINY, device=device)


def main(argv=None, tokenizer=None, clap_tokenizer=None):
    args = parse_args(argv)
    import numpy as np

    from tango_tpu_torch.audio.wav import write_wav
    from tango_tpu_torch.inference import init_tracker, load_prompts
    from tango_tpu_torch.pipeline import Tango

    out_dir = args.output_dir or os.path.join(
        "outputs", f"tango2_{int(time.time())}_steps_{args.num_steps}")
    os.makedirs(out_dir, exist_ok=True)
    prompts = load_prompts(args)

    tango = Tango(args.model, tokenizer=tokenizer, unet_ckpt=args.unet_ckpt, device=args.device)
    t0 = time.time()
    waves = tango.generate_for_batch(prompts, steps=args.num_steps, guidance=args.guidance,
                                     batch_size=args.batch_size, seed=args.seed)
    gen_time = time.time() - t0
    for i, w in enumerate(waves):
        write_wav(os.path.join(out_dir, f"output_{i}.wav"), w, 16000)

    record = {
        "model": args.model,
        "num_prompts": len(prompts),
        "num_steps": args.num_steps,
        "gen_time_s": round(gen_time, 2),
        "x_realtime": round(len(prompts) * 10.24 / gen_time, 3),
        "output_dir": out_dir,
    }
    if args.clap_ckpt:
        clap = load_clap(args.clap_ckpt, clap_tokenizer, args.device)
        wav_f = np.stack([w.astype(np.float32) / 32768.0 for w in waves])
        record["clap_score"] = round(clap.clap_score(wav_f, prompts), 4)
        del clap
    if args.reference_dir:
        from tango_tpu_torch.eval.evaluator import EvaluationHelper

        record["metrics"] = EvaluationHelper(
            16000, device=args.device, cnn14_ckpt=args.cnn14_ckpt,
            vggish_ckpt=args.vggish_ckpt).main(out_dir, args.reference_dir)

    tracker = init_tracker(args.with_tracking)
    if tracker is not None:
        wb = dict(record.get("metrics") or {})
        wb.update({"Steps": args.num_steps, "Guidance Scale": args.guidance,
                   "Test Instances": len(prompts)})
        if "clap_score" in record:
            wb["clap_score"] = record["clap_score"]
        tracker.log(wb)
        tracker.finish()
    with open("summary.jsonl", "a") as f:
        f.write(json.dumps(record) + "\n")
    print(json.dumps(record, indent=2))
    return record


if __name__ == "__main__":
    main()

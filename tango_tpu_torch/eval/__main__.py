"""Objective-evaluation CLI, port of tango_tpu/eval/__main__.py:

    python -m tango_tpu_torch.eval generated/ groundtruth/ \
        --cnn14_ckpt Cnn14_16k_mAP=0.438.pth --vggish_ckpt vggish.pth [--device cpu]

Runs EvaluationHelper's metric set over two WAV directories and writes the
reference's `<gen_dir>_evaluation_results.json`; prints the result as JSON.
Cnn14 and VGGish run on the card unless --device names another.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description="FD/FAD/KL/IS/KID/LSD/PSNR/SSIM over two wav dirs")
    p.add_argument("generation_result_path", help="generated wav dir")
    p.add_argument("target_audio_path", help="ground-truth wav dir")
    p.add_argument("--limit_num", type=int, default=None,
                   help="evaluate only the first N files (eval.py limit_num)")
    p.add_argument("--cnn14_ckpt", type=str, default=None,
                   help="Cnn14 16k checkpoint for FD/KL/IS/KID (those metrics are NaN without it)")
    p.add_argument("--vggish_ckpt", type=str, default=None, help="VGGish checkpoint for FAD")
    p.add_argument("--output", type=str, default=None,
                   help="extra result json copy (the helper always writes "
                        "<gen_dir>_evaluation_results.json like the reference)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card unless given (e.g. cpu)")
    args = p.parse_args(argv)

    from tango_tpu_torch.eval.evaluator import EvaluationHelper

    helper = EvaluationHelper(cnn14_ckpt=args.cnn14_ckpt, vggish_ckpt=args.vggish_ckpt,
                              device=args.device)
    result = helper.main(args.generation_result_path, args.target_audio_path,
                         limit_num=args.limit_num)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

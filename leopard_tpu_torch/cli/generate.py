"""Generate from a Leopard-LLaVA HF checkpoint: a multi-image prompt → text
(port of examples/generate.py).

  python -m leopard_tpu_torch.cli.generate --checkpoint /ckpts/leopard-llava-hf \
      --tokenizer /ckpts/leopard-llava-hf \
      --question "<image> What does the slide say?" \
      --images slide1.png slide2.png --beam 0

`generate(args, tokenizer, cfg)` is the whole path for a caller that has
built its own tokenizer or config; `main` builds both from the flags.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from leopard_tpu_torch.cli import add_device_arg, resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True, help="HF checkpoint dir")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--question", required=True)
    p.add_argument("--images", nargs="*", default=[])
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=0.0)
    p.add_argument("--beam", type=int, default=0, help=">0 enables beam search")
    p.add_argument("--greedy", action="store_true", default=None)
    add_device_arg(p)
    return p.parse_args(argv)


def generate(args: argparse.Namespace, tokenizer=None, cfg=None) -> np.ndarray:
    """Load the checkpoint onto the device, answer the question about the
    images, print the text and return the tokens."""
    device = resolve_device(args.device)
    from PIL import Image

    from leopard_tpu_torch.config import GenerateConfig, leopard_llava_8b
    from leopard_tpu_torch.convert.hf import load_leopard_llava
    from leopard_tpu_torch.data.processor import LeopardProcessor
    from leopard_tpu_torch.data.tokenizer import build_tokenizer
    from leopard_tpu_torch.inference.beam import beam_search
    from leopard_tpu_torch.inference.engine import Engine

    cfg = cfg or leopard_llava_8b()
    tokenizer = tokenizer or build_tokenizer(args.tokenizer or args.checkpoint)
    model = load_leopard_llava(args.checkpoint, cfg, device)

    greedy = args.greedy if args.greedy is not None else (
        args.top_k == 0 and args.top_p == 0.0 and args.temperature == 1.0)
    gen_cfg = GenerateConfig(
        max_new_tokens=args.max_new_tokens, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p, greedy=greedy, eos_token_ids=(128001, 128009))
    engine = Engine(cfg, model, gen_cfg)
    processor = LeopardProcessor(cfg, tokenizer, layout="eval")

    images = []
    for path in args.images:
        with Image.open(path) as im:
            images.append(im.convert("RGB"))
    prompt, pixels = processor.process_eval(args.question, images)
    pixels = pixels if images else None

    if args.beam > 0:
        tokens = beam_search(engine, prompt, images=pixels, beam_width=args.beam,
                             max_new_tokens=args.max_new_tokens)
    else:
        tokens = engine.generate([prompt], images=pixels, gen_cfg=gen_cfg).tokens[0]
    print(tokenizer.decode(tokens.tolist(), skip_special_tokens=True), flush=True)
    return tokens


def main(argv: Optional[Sequence[str]] = None) -> None:
    generate(parse_args(argv))


if __name__ == "__main__":
    main()

"""Serve a Leopard HF checkpoint over HTTP (port of examples/serve.py).

  # plain engine (sampling, logprobs, optional speculative decoding)
  python -m leopard_tpu_torch.cli.serve --checkpoint /ckpts/leopard-llava-hf \
      --tokenizer /ckpts/leopard-llava-hf --port 5000 --quantize int4 --spec 7

  # continuous batching (slot refill, per-request token budgets)
  python -m leopard_tpu_torch.cli.serve --checkpoint /ckpts/leopard-llava-hf \
      --continuous --slots 8 --cache-len 2048 --quantize int8

  # Leopard-Idefics2 (NaViT images, perceiver, Mistral with its window)
  python -m leopard_tpu_torch.cli.serve --arch leopard_idefics2 \
      --checkpoint /ckpts/leopard-idefics2-hf --port 5000

`build_server(args, tokenizer, cfg)` gives the GenerationServer, built and
not yet serving (`--port 0` takes a free port once `http_server()` binds
it); `main` serves it until interrupted.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from leopard_tpu_torch.cli import add_device_arg, resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--quantize", default=None, choices=[None, "int8", "int4"])
    p.add_argument("--arch", default="leopard_llava",
                   choices=["leopard_llava", "leopard_idefics2"])
    p.add_argument("--spec", type=int, default=0, metavar="DRAFT",
                   help="prompt-lookup speculative decoding draft length for "
                        "greedy requests (0 = off); token-identical output")
    p.add_argument("--spec-ngram", type=int, default=2)
    p.add_argument("--continuous", action="store_true",
                   help="serve through the continuous-batching slot pool")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--cache-len", type=int, default=2048)
    p.add_argument("--max-new-cap", type=int, default=512)
    p.add_argument("--system-prompt", default=None,
                   help="shared system prompt, prefilled once and KV-cached "
                        "(prefix caching), put before every request")
    add_device_arg(p)
    args = p.parse_args(argv)
    if args.spec and args.system_prompt:
        p.error("--spec and --system-prompt (prefix caching) are mutually exclusive")
    if args.spec and args.continuous:
        p.error("--spec applies only to the plain engine path; the "
                "continuous slot pool decodes one token per row per step. "
                "Drop one of --spec / --continuous.")
    return args


def build_server(args: argparse.Namespace, tokenizer=None, cfg=None):
    """Load the checkpoint onto the device and build the server over it."""
    device = resolve_device(args.device)
    from leopard_tpu_torch.config import leopard_idefics2_8b, leopard_llava_8b
    from leopard_tpu_torch.convert.hf import load_leopard_idefics2, load_leopard_llava
    from leopard_tpu_torch.data.tokenizer import build_tokenizer
    from leopard_tpu_torch.inference.continuous import ContinuousEngine
    from leopard_tpu_torch.inference.engine import Engine
    from leopard_tpu_torch.inference.server import GenerationServer
    from leopard_tpu_torch.inference.speculative import SpecConfig

    idefics2 = args.arch == "leopard_idefics2"
    cfg = cfg or (leopard_idefics2_8b() if idefics2 else leopard_llava_8b())
    tokenizer = tokenizer or build_tokenizer(args.tokenizer or args.checkpoint)
    load = load_leopard_idefics2 if idefics2 else load_leopard_llava
    model = load(args.checkpoint, cfg, device)
    engine = Engine(cfg, model, quantize=args.quantize, quantize_kv=args.quantize is not None)
    del model  # with --quantize, the engine holds its own text weights
    continuous = None
    if args.continuous:
        continuous = ContinuousEngine(engine, slots=args.slots, cache_len=args.cache_len,
                                      max_new_cap=args.max_new_cap)
    spec = SpecConfig(ngram=args.spec_ngram, draft=args.spec) if args.spec else None
    prefix = None
    if args.system_prompt:
        ids = tokenizer(args.system_prompt, add_special_tokens=True)["input_ids"]
        prefix = engine.build_prefix(np.asarray(ids, np.int32))
        print(f"system prompt cached: {prefix.length} tokens", flush=True)
    return GenerationServer(engine, tokenizer, args.host, args.port,
                            continuous=continuous, spec=spec, prefix=prefix)


def main(argv: Optional[Sequence[str]] = None) -> None:
    build_server(parse_args(argv)).serve_forever()


if __name__ == "__main__":
    main()

"""Run the evaluation suite on a Leopard HF checkpoint (port of
examples/run_eval.py): shard → generate → score → group_acc → merge, the
reference's run_eval_llava_siglip_multiimg.sh protocol.

  python -m leopard_tpu_torch.cli.run_eval --checkpoint /ckpts/leopard-llava-hf \
      --datasets docvqa slidevqa --data-root /data/eval \
      --setting direct --result-dir results/ [--quantize int4] [--prefix-caching]

  # Leopard-Idefics2; two shards, shard 0 last (it merges)
  python -m leopard_tpu_torch.cli.run_eval --arch leopard_idefics2 \
      --checkpoint /ckpts/leopard-idefics2-hf --datasets mirb --data-root /data/eval \
      --num-shards 2 --shard 1
  python -m leopard_tpu_torch.cli.run_eval ... --num-shards 2 --shard 0

Each shard writes `<shard>_<setting>_<dataset>_shard_details.jsonl`; shard 0
(or the only one) then merges every shard file present into
`<dataset>_<setting>_acc.json` and `_details.jsonl`, and writes
`all_bench_results.json`. `--set text.num_layers=4` runs a checkpoint of a
cut depth. `run_eval(args, tokenizer, cfg)` is the whole path for a caller
that has built its own tokenizer or config.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from leopard_tpu_torch.cli import add_device_arg, resolve_device
from leopard_tpu_torch.cli.train_leopard_llava import parse_overrides

DEFAULT_DATASETS = ["mpdocvqa", "dude", "slidevqa", "mirb", "mmmu", "mathvista",
                    "scienceqa", "textvqa", "docvqa", "visualwebbench"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--datasets", nargs="+", default=DEFAULT_DATASETS)
    p.add_argument("--data-root", required=True,
                   help="directory containing one subdir (or prepared "
                        "eval_<name>.jsonl) per benchmark")
    p.add_argument("--setting", default="direct", choices=["direct", "cot", "none"])
    p.add_argument("--result-dir", default="eval_results")
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--max-samples", type=int, default=0)
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=8,
                   help="rows per engine batch (1 = the serial loop)")
    p.add_argument("--arch", default="leopard_llava",
                   choices=["leopard_llava", "leopard_idefics2"])
    p.add_argument("--quantize", default=None, choices=["int8", "int4"],
                   help="weight-only decoder quantization (also stores the "
                        "KV cache int8)")
    p.add_argument("--spec", type=int, default=0, metavar="DRAFT",
                   help="prompt-lookup speculative decoding with this draft "
                        "length (0 = off); token-identical to plain greedy")
    p.add_argument("--spec-ngram", type=int, default=2)
    p.add_argument("--prefix-caching", action="store_true",
                   help="prefill each batch's common prompt header once and "
                        "seed it into every row; ignored with --spec")
    p.add_argument("--set", action="append", default=[],
                   help="dotted config override, e.g. text.num_layers=4")
    add_device_arg(p)
    args = p.parse_args(argv)
    if args.arch == "leopard_idefics2" and args.quantize == "int4":
        # K4 (and the JAX package's int4 matmul) needs N % 128 == 0: Mistral's
        # head is 32,003 wide, so the first decode step would fail
        p.error("--quantize int4 is not servable with --arch leopard_idefics2: the int4 "
                "matmul needs an output width that is a multiple of 128, and the Mistral "
                "head is 32,003 wide")
    return args


def run_eval(args: argparse.Namespace, tokenizer=None, cfg=None):
    """Load the checkpoint onto the device and evaluate every dataset.
    Returns the merged results (all_bench_results.json) on shard 0, else
    None."""
    device = resolve_device(args.device)
    from leopard_tpu_torch import config as cfgs
    from leopard_tpu_torch.convert.hf import load_leopard_idefics2, load_leopard_llava
    from leopard_tpu_torch.data.tokenizer import build_tokenizer
    from leopard_tpu_torch.evaluation.adapter import (
        LeopardIdefics2EvalAdapter,
        LeopardLlavaEvalAdapter,
    )
    from leopard_tpu_torch.evaluation.harness import (
        merge_all_bench_results,
        merge_shard_files,
        run_benchmark,
        run_benchmark_batched,
    )
    from leopard_tpu_torch.evaluation.loaders import load_benchmark, write_jsonl
    from leopard_tpu_torch.inference.speculative import SpecConfig

    idefics2 = args.arch == "leopard_idefics2"
    cfg = cfg or (cfgs.leopard_idefics2_8b() if idefics2 else cfgs.leopard_llava_8b())
    cfg = cfgs.apply_overrides(cfg, parse_overrides(args.set))
    tokenizer = tokenizer or build_tokenizer(args.tokenizer or args.checkpoint)
    spec = SpecConfig(ngram=args.spec_ngram, draft=args.spec) if args.spec else None
    serve_kw = dict(quantize=args.quantize, quantize_kv=args.quantize is not None,
                    spec=spec, prefix_caching=args.prefix_caching)
    load = load_leopard_idefics2 if idefics2 else load_leopard_llava
    model = load(args.checkpoint, cfg, device)
    if idefics2:
        eos = tokenizer.convert_tokens_to_ids("<end_of_utterance>")
        gen_cfg = cfgs.GenerateConfig(
            max_new_tokens=args.max_new_tokens, greedy=True,
            eos_token_ids=tuple(t for t in (tokenizer.eos_token_id, eos) if t))
        adapter = LeopardIdefics2EvalAdapter(cfg, model, tokenizer, gen_cfg=gen_cfg, **serve_kw)
    else:
        gen_cfg = cfgs.GenerateConfig(max_new_tokens=args.max_new_tokens, greedy=True,
                                      eos_token_ids=(128001, 128009))
        adapter = LeopardLlavaEvalAdapter(cfg, model, tokenizer, gen_cfg=gen_cfg, **serve_kw)
    del model  # with --quantize, the engine holds its own text weights

    os.makedirs(args.result_dir, exist_ok=True)
    for dataset in args.datasets:
        rows = load_benchmark(dataset, os.path.join(args.data_root, dataset))
        if args.max_samples:
            rows = rows[: args.max_samples]
        if args.batch_size > 1:
            details = run_benchmark_batched(
                rows, adapter, dataset, args.setting,
                shard=args.shard, num_shards=args.num_shards,
                batch_size=args.batch_size, progress=True,
            )
        else:
            details = run_benchmark(
                rows, adapter, dataset, args.setting,
                shard=args.shard, num_shards=args.num_shards, progress=True,
            )
        write_jsonl(os.path.join(
            args.result_dir, f"{args.shard}_{args.setting}_{dataset}_shard_details.jsonl"),
            details)
        if args.num_shards == 1 or args.shard == 0:
            report = merge_shard_files(args.result_dir, dataset, args.setting)
            print(dataset, report, flush=True)

    if args.shard == 0:
        merged = merge_all_bench_results(args.result_dir)
        print(merged, flush=True)
        return merged
    return None


def main(argv: Optional[Sequence[str]] = None) -> None:
    run_eval(parse_args(argv))


if __name__ == "__main__":
    main()

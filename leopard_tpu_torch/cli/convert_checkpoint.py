"""Checkpoint conversion, HF ↔ the port's native checkpoint (port of
tools/convert_checkpoint.py), both directions:

  # HF → native (CheckpointManager, parameters alone, step 0)
  python -m leopard_tpu_torch.cli.convert_checkpoint --direction hf2native \
      --arch leopard_llava --input /ckpts/leopard-llava-hf --output ckpt/

  # native → HF (fp32 tensors in one model.safetensors)
  python -m leopard_tpu_torch.cli.convert_checkpoint --direction native2hf \
      --arch leopard_llava --input ckpt/ --output /ckpts/export/

`--arch leopard_idefics2` takes an Idefics2ForConditionalGeneration checkpoint.
`--arch llama` and `--arch mistral` convert the text decoder alone
(`model.*` keys) of Leopard-LLaVA and Leopard-Idefics2; native2hf writes
their `config.json` beside the tensors (a tied decoder: no `lm_head.weight`,
`tie_word_embeddings: true`).
`convert(args, cfg)` is the whole path for a caller with its own config.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from leopard_tpu_torch.cli import add_device_arg, resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--direction", choices=["hf2native", "native2hf"], required=True)
    p.add_argument("--arch", default="leopard_llava",
                   choices=["leopard_llava", "leopard_idefics2", "llama", "mistral"])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    add_device_arg(p)
    return p.parse_args(argv)


def convert(args: argparse.Namespace, cfg=None) -> None:
    """hf2native: read the HF tensors onto the device, convert them to the
    config's dtype there, save them. native2hf: restore the parameters on
    the host and write them as fp32."""
    device = resolve_device(args.device)
    from leopard_tpu_torch.config import leopard_idefics2_8b, leopard_llava_8b
    from leopard_tpu_torch.convert import hf as chf
    from leopard_tpu_torch.training.checkpoint import CheckpointManager

    # llama and mistral: the text part of their family's config only
    idefics2 = args.arch in ("leopard_idefics2", "mistral")
    cfg = cfg or (leopard_idefics2_8b() if idefics2 else leopard_llava_8b())
    # the whole model's converter and export; None for a text decoder alone
    convert_vlm, export_vlm = {
        "leopard_llava": (chf.convert_leopard_llava, chf.export_leopard_llava),
        "leopard_idefics2": (chf.convert_leopard_idefics2, chf.export_leopard_idefics2),
    }.get(args.arch, (None, None))

    if args.direction == "hf2native":
        sd = chf.load_hf_state_dict(args.input, device)
        if convert_vlm is not None:
            params = convert_vlm(sd, cfg, device=device)
        else:
            params = {"text." + k: v for k, v in
                      chf.convert_decoder(sd, cfg.text, "model.", device=device).items()}
        mgr = CheckpointManager(args.output, async_save=False)
        mgr.save(0, params, config={"arch": args.arch})
        mgr.close()
        print(f"saved native checkpoint to {args.output}", flush=True)
        return

    from safetensors.torch import save_file

    mgr = CheckpointManager(args.input, async_save=False)
    params, _ = mgr.restore()
    mgr.close()
    if export_vlm is not None:
        sd = export_vlm(params, cfg)
    else:
        sd = chf.export_decoder({k[len("text."):]: v for k, v in params.items()
                                 if k.startswith("text.")}, cfg.text, "model.")
    del params
    os.makedirs(args.output, exist_ok=True)
    save_file({k: v.float().contiguous() for k, v in sd.items()},
              os.path.join(args.output, "model.safetensors"))
    if export_vlm is None:
        with open(os.path.join(args.output, "config.json"), "w") as f:
            json.dump(chf.hf_decoder_config(cfg.text), f, indent=2)
    print(f"exported {len(sd)} tensors to {args.output}", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    convert(parse_args(argv))


if __name__ == "__main__":
    main()

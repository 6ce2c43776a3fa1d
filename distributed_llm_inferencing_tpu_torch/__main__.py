"""CLI of the port:

- ``python -m distributed_llm_inferencing_tpu_torch worker [--host
  --port --device --role]`` starts the worker agent (runtime/worker.py);
- ``python -m distributed_llm_inferencing_tpu_torch convert
  --checkpoint_path DIR --out DIR [--dtype --quantize --embed_quantize
  --device]`` converts an HF checkpoint directory into a native checkpoint
  (models/checkpoint.py), tokenizer files included; ``--model_name NAME
  --allow_random_init`` writes a registry row's random weights instead.
  The flags are the JAX CLI's; ``--device`` (default cuda) is where the
  conversion runs.
"""

from __future__ import annotations

import argparse
import sys

USAGE = ("usage: python -m distributed_llm_inferencing_tpu_torch "
         "{worker [--host H] [--port P] [--device cuda|cpu] "
         "[--role prefill|decode|mixed] | convert "
         "--out DIR (--checkpoint_path DIR | --model_name NAME "
         "--allow_random_init) [--dtype D] [--quantize int8|int4] "
         "[--embed_quantize int8] [--device cuda|cpu]}")


def convert(argv) -> int:
    from distributed_llm_inferencing_tpu_torch.ops.quant import MODES
    p = argparse.ArgumentParser(prog="convert")
    p.add_argument("--checkpoint_path", help="local HF checkpoint dir")
    p.add_argument("--model_name", help="registry name (with "
                                        "--allow_random_init, for testing)")
    p.add_argument("--allow_random_init", action="store_true")
    p.add_argument("--out", required=True)
    p.add_argument("--dtype", choices=["bfloat16", "float32"])
    p.add_argument("--quantize", choices=list(MODES))
    p.add_argument("--embed_quantize", choices=["int8"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from distributed_llm_inferencing_tpu_torch.models import checkpoint
    if args.checkpoint_path:
        cfg = checkpoint.convert_hf_to_native(
            args.checkpoint_path, args.out, dtype=args.dtype,
            quantize=args.quantize, embed_quantize=args.embed_quantize,
            device=args.device)
    elif args.allow_random_init and args.model_name:
        import torch
        from distributed_llm_inferencing_tpu_torch.models.params import (
            init_params)
        from distributed_llm_inferencing_tpu_torch.models.registry import (
            get_config)
        from distributed_llm_inferencing_tpu_torch.utils.device import (
            resolve_device)
        cfg = get_config(args.model_name).replace(
            quant=args.quantize, embed_quant=args.embed_quantize)
        if args.dtype:
            cfg = cfg.replace(dtype=args.dtype)
        dev = resolve_device(args.device)
        checkpoint.save_checkpoint(args.out, cfg, init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev))
    else:
        print("need --checkpoint_path, or --model_name with "
              "--allow_random_init", file=sys.stderr)
        return 2
    print(f"saved native checkpoint for {cfg.name} -> {args.out}")
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["convert"]:
        return convert(argv[1:])
    if argv[:1] != ["worker"]:
        print(USAGE, file=sys.stderr)
        return 2
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        main as worker_main)
    worker_main(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())

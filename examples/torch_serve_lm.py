"""Serving example on the PyTorch/CUDA port: batched greedy generation
with prefill + KV-cache decode through the block-space flash kernel,
then the same requests through the paged KV pool (continuous batching
through the paged decode kernel).

Serves randomly initialised weights (a seeded ``torch.Generator``) of
the quickstart model, at full width unless ``--smoke``.  Runs on the
card by default; ``--device cpu`` runs the kernels' plain PyTorch
versions instead.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu] [--smoke]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import backend
from repro_torch.launch.serve import (PagedServeConfig, PagedServer,
                                      ServeConfig, Server,
                                      paged_throughput_report,
                                      throughput_report)
from repro_torch.models import init


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced quickstart config (2 layers)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = backend.default_device(args.device)

    cfg = get_config("quickstart", smoke=args.smoke).replace(
        attn_decode_kernel="blockspace")
    model = init(cfg, torch.Generator(device=device).manual_seed(0), device)
    print(f"serving randomly initialised {cfg.name} weights "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}) on {device}")
    # a cache length that tiles the kernel's 128-key blocks
    max_len = -(-(args.prompt_len + args.max_new) // 128) * 128
    server = Server(cfg, model, ServeConfig(max_len=max_len,
                                            temperature=args.temperature))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    out = server.generate(prompts, max_new=args.max_new)
    for i, row in enumerate(out[:2]):
        print(f"request {i}: {row.tolist()}")
    print("contiguous:", throughput_report(server, args.batch,
                                           args.prompt_len, args.max_new))

    paged = PagedServer(cfg, model, PagedServeConfig(
        max_len=args.prompt_len + args.max_new,
        temperature=args.temperature, num_slots=max(1, args.batch // 2),
        page_size=16, num_pages=64))
    rep = paged_throughput_report(paged, list(prompts), max_new=args.max_new)
    if args.temperature <= 0:
        same = all(np.array_equal(paged.done[i], out[i])
                   for i in range(args.batch))
        print(f"paged streams equal the contiguous ones: {same}")
    print("paged:", rep)


if __name__ == "__main__":
    main()

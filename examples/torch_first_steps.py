"""The first AdamW steps of a model on the PyTorch/CUDA port, at full
width and cut depth, under variants that each change one thing: the
compute dtype, the attention path, the learning rate.  Every variant
starts from the same seeded weights and takes the same batches, so
their losses differ only by what the variant changed.  Beside each
step's loss (a new batch each step) it prints the loss of the first
batch after every update: on one batch, a rise is the update's doing,
not the next batch's.

The run is ``chip_smoke.py``'s gemma3-12b training run (RUN: 6 of its
48 layers, batch 1 x 4096, lr 1e-4 warmed up over 1 step, 3 steps); one
JSON line per variant.

On the card:   PYTHONPATH=src python examples/torch_first_steps.py
On the CPU:    PYTHONPATH=src python examples/torch_first_steps.py \\
                   --smoke --device cpu
"""
import argparse
import json
import subprocess
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.launch import train as TT
from repro_torch.models import loss_fn
from repro_torch.optim.adamw import AdamWConfig

#: chip_smoke.py's gemma3-12b run (TRAIN_GEMMA, and its warmup_steps 1)
RUN = dict(arch="gemma3-12b", layers=6, batch=1, seq=4096, steps=3,
           lr=1e-4, warmup=1)
#: name -> (config changes, factor on RUN's learning rate or None)
VARIANTS = {
    "as_run": ({}, None),
    "f32_compute": ({"dtype": "float32"}, None),
    "lr_tenth": ({}, 0.1),
    "plain_attention": ({"flash_threshold": 1 << 30}, None),
}


def first_steps(cfg, steps, batch, seq, lr, warmup, device, seed=0):
    """``steps`` steps of ``make_train_step`` from ``Trainer.init_params``;
    returns the metrics of each step, the first batch's loss before the
    first update and after each, and the card's peak memory in GiB (None
    on the CPU)."""
    tcfg = TT.TrainConfig(steps=steps, seed=seed,
                          ckpt_dir=tempfile.gettempdir(),
                          optimizer=AdamWConfig(lr=lr, warmup_steps=warmup,
                                                total_steps=steps))
    tr = TT.Trainer(cfg, tcfg, device=device)
    cuda = torch.device(tr.device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    step = TT.make_train_step(cfg, tcfg)
    model, opt = tr.init_params()
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=seq, global_batch=batch,
                                        seed=seed))
    batches = [tr._device_batch(pipe.next_batch()) for _ in range(steps)]

    def first_loss():
        with torch.no_grad():
            return float(loss_fn(model, batches[0], cfg)[1]["loss"])
    hist, first = [], [first_loss()]
    for b in batches:
        model, opt, met = step(model, opt, b)
        hist.append({k: float(v) for k, v in met.items()})
        first.append(first_loss())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
    del model, opt
    if cuda:
        torch.cuda.empty_cache()
    return hist, first, peak


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config at seq 64")
    ap.add_argument("--only", default="",
                    help="comma-separated variants (default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(RUN["arch"], smoke=True if args.smoke else None)
    if not args.smoke:
        cfg = cfg.replace(n_layers=RUN["layers"])
    seq = 64 if args.smoke else RUN["seq"]
    if args.device != "cpu" and torch.cuda.is_available():
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    names = args.only.split(",") if args.only else list(VARIANTS)
    for name in names:
        changes, lr_factor = VARIANTS[name]
        vcfg = cfg.replace(**changes)
        lr = RUN["lr"] * (lr_factor or 1.0)
        row = {"variant": name, "arch": cfg.name, "layers": cfg.n_layers,
               "dtype": vcfg.dtype, "param_dtype": vcfg.param_dtype,
               "flash": seq > vcfg.flash_threshold, "lr": lr}
        try:
            hist, first, peak = first_steps(vcfg, RUN["steps"], RUN["batch"],
                                            seq, lr, RUN["warmup"],
                                            args.device)
        except torch.OutOfMemoryError as e:  # the other variants go on
            torch.cuda.empty_cache()
            print(json.dumps({**row, "error": str(e)[:200]}), flush=True)
            continue
        print(json.dumps({
            **row, "losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            "lrs": [h["lr"] for h in hist],
            "first_batch_losses": first, "peak_gib": peak}), flush=True)


if __name__ == "__main__":
    main()

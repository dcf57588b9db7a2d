"""End-to-end training example on the PyTorch/CUDA port: train the
~100M-parameter quickstart LM on the synthetic pipeline for a few
hundred steps with checkpoint/restart (re-running resumes from the last
checkpoint in ``--ckpt-dir``).

Runs on the card by default; ``--device cpu`` trains on the CPU.

Smoke (seconds):   PYTHONPATH=src python examples/torch_train_lm.py \\
                       --smoke --device cpu
Full 100M run:     PYTHONPATH=src python examples/torch_train_lm.py \\
                       --steps 300 --global-batch 16 --seq-len 256
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.launch.train import TrainConfig, Trainer
from repro_torch.optim.adamw import AdamWConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_quickstart_ckpt"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config("quickstart", smoke=args.smoke)
    print(f"model: {cfg.name} ({cfg.param_count() / 1e6:.1f}M params)")

    tcfg = TrainConfig(
        steps=args.steps if not args.smoke else 20,
        log_every=10,
        ckpt_every=100,
        ckpt_dir=args.ckpt_dir,
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=20,
                              total_steps=args.steps))
    pipe = SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size,
        seq_len=args.seq_len if not args.smoke else 64,
        global_batch=args.global_batch if not args.smoke else 4))

    trainer = Trainer(cfg, tcfg, device=args.device)
    model, opt_state, history = trainer.run(pipe)
    first = sum(h["loss"] for h in history[:5]) / max(1, len(history[:5]))
    last = sum(h["loss"] for h in history[-5:]) / max(1, len(history[-5:]))
    print(f"\nloss: {first:.3f} -> {last:.3f} over {len(history)} steps "
          f"on {trainer.device}")
    print(f"checkpoints in {args.ckpt_dir} (resume by re-running)")


if __name__ == "__main__":
    main()

"""End-to-end driver #2 on the port: train an LM for a few hundred steps.

The counterpart of ``examples/train_lm.py`` on
``repro_torch.launch.train.Trainer`` (checkpointing, watchdog,
optimizer): a reduced config by default, so it runs on the CPU in
minutes with ``--device cpu``; ``--full`` takes the published widths
(for the card).  Loss must drop well below ln(vocab) on the synthetic
motif dataset.  Without ``--device`` it runs on the card.  Every config
trains, the hybrid zamba2-1.2b and xlstm-1.3b among them.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --arch olmo-1b \\
          --steps 300 --device cpu
      PYTHONPATH=src python examples/train_lm_torch.py --arch xlstm-1.3b \\
          --steps 100 --device cpu
"""
import argparse

from repro_torch.configs import get_arch, reduced
from repro_torch.launch.train import Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args()

    spec = get_arch(args.arch)
    cfg = spec.model if args.full else reduced(spec.model)
    cfg = cfg.replace(max_seq=max(cfg.max_seq, 128))
    tr = Trainer(cfg, optimizer=spec.optimizer, seq_len=128, global_batch=8,
                 ckpt_dir=args.ckpt_dir, peak_lr=3e-3,
                 torch_device=args.device)
    if tr.maybe_restore():
        print(f"resumed from step {tr.step}")
    hist = tr.train(args.steps, log_every=25)
    start, end = hist["loss"][0], hist["loss"][-1]
    print(f"\nloss {start:.3f} -> {end:.3f} over {args.steps} steps "
          f"({'LEARNING' if end < start - 0.3 else 'check config'})")


if __name__ == "__main__":
    main()

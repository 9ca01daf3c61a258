"""End-to-end training driver: a dense LM trained on the synthetic pipeline
with AdapTBF-paced checkpoint + data I/O, async checkpointing, and
crash-resume support.  On a CUDA device every step runs the flash attention
kernel forward and backward once a layer.

Defaults are a small demo (~13M params, 100 steps).  The 100M-parameter
preset:

  PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m \
      --steps 300

Resume after a crash by re-running the same command: the trainer restores
the latest checkpoint under ``--ckpt-dir`` automatically.
"""
import argparse
import os
import tempfile

from repro_torch.models.common import ModelConfig
from repro_torch.storage import AdapTBFController
from repro_torch.training import Trainer

PRESETS = {
    "demo": dict(n_layers=6, d_model=256, n_heads=8, kv_heads=4, d_ff=1024,
                 vocab=8192),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, kv_heads=12,
                 d_ff=3072, vocab=32064),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="demo")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--grad-compression", choices=("none", "bf16_sr"),
                    default="none")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = ModelConfig(name=f"train-lm-{args.preset}", **PRESETS[args.preset])
    print(f"model: {cfg.name}  ~{cfg.param_count()/1e6:.1f}M params")

    controller = AdapTBFController(n_targets=4, capacity_rpc_per_s=4000,
                                   device=args.device)
    trainer = Trainer(
        cfg,
        ckpt_dir=args.ckpt_dir,
        global_batch=args.batch,
        seq_len=args.seq,
        ckpt_every=args.ckpt_every,
        controller=controller,
        grad_compression=args.grad_compression,
        lr=args.lr,
        warmup=20,
        total_steps=max(args.steps, 100),
        device=args.device,
    )
    if trainer.step:
        print(f"resumed from checkpoint at step {trainer.step}")
    hist = trainer.run(args.steps)
    for i in range(0, len(hist), max(len(hist) // 10, 1)):
        h = hist[i]
        print(f"step {trainer.step - len(hist) + i + 1:5d}  "
              f"loss {h['loss']:.4f}  gnorm {h['grad_norm']:.3f}  "
              f"lr {h['lr']:.2e}")
    print(f"final loss {hist[-1]['loss']:.4f}")
    print(f"checkpoint I/O went through AdapTBF: "
          f"{controller.windows_run} allocation windows ran")
    trainer.close()      # the background save of the last step lands first
    trainer.save_now()
    return hist


if __name__ == "__main__":
    main()

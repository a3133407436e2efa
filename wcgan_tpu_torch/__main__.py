"""``python -m wcgan_tpu_torch`` — the PyTorch port's training CLI."""

from wcgan_tpu_torch.cli.run import main

if __name__ == "__main__":
  raise SystemExit(main())

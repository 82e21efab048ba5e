"""`python -m msnv_tpu_torch.serving` — same entry as msnv-serve-torch."""

from msnv_tpu_torch.serving.cli import main

if __name__ == "__main__":
    main()

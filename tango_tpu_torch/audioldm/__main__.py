"""`python -m tango_tpu_torch.audioldm`: the AudioLDM CLI (cli.py)."""

from tango_tpu_torch.audioldm.cli import main

if __name__ == "__main__":
    main()

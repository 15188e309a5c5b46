"""``python -m depthmap_tpu_torch``: the command-line frontend
(``depthmap_tpu_torch/cli.py``)."""
from depthmap_tpu_torch.cli import main

if __name__ == "__main__":
    main()

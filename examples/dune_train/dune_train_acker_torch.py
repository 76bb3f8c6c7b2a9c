"""Train a DUNE model for the default Ackermann robot on the PyTorch port
(the counterpart of ``dune_train_acker.py``; imports no JAX).

    python examples/dune_train/dune_train_acker_torch.py [--device cpu]
        [--epoch N] [--data-size N] [--out DIR]

The same options as ``dune_train_diff_torch.py``, from
``dune_train_acker.yaml``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dune_train_diff_torch import main  # noqa: E402

if __name__ == "__main__":
    main("dune_train_acker.yaml")

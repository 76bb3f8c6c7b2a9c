"""LON tuning on the PyTorch port in a second environment, dyna_obs/diff
(moving obstacles): the counterpart of ``LON_dyna_obs.py``, the same
tuning and evaluation harness (LON_corridor_torch.main) with its
collision-threshold default of 0.85 (at 0.4 the untuned episode's loss is
identically zero). Results: results_dyna_obs_torch.txt (or LON_SAVE).

    python examples/LON/LON_dyna_obs_torch.py [--device cpu]
"""

import os
import sys

os.environ.setdefault("LON_SCENARIO", "dyna_obs/diff")
os.environ.setdefault("LON_COLL", "0.85")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from LON_corridor_torch import device_arg, main  # noqa: E402

if __name__ == "__main__":
    save = os.environ.get(
        "LON_SAVE",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "results_dyna_obs_torch.txt"))
    main(save_path=save, device=device_arg())

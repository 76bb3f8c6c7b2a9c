from neupan_torch.training.dune_train import DuneTrainer  # noqa: F401
from neupan_torch.training.labels import (  # noqa: F401
    dual_ascent_labels,
    polygon_distance_labels,
)

"""Classification losses: port of ``iif_tpu/losses`` (IIF, CE, focal /
BCE, mixup and the criterion factory)."""
from iif_torch.losses.ce import CrossEntropyLoss, softmax_cross_entropy  # noqa: F401
from iif_torch.losses.factory import get_criterion, get_deferred_weights  # noqa: F401
from iif_torch.losses.focal import FocalLoss  # noqa: F401
from iif_torch.losses.iif import IIF_VARIANTS, IIFLoss, compute_iif_weights  # noqa: F401
from iif_torch.losses.mixup import mixup_batch, mixup_criterion, sample_mixup  # noqa: F401

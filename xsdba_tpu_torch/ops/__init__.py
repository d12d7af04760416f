"""Tensor operators of the port; ``ops.cuda`` holds the hand-written kernels.
The package resolves the names the JAX package's ``ops`` resolves."""

from .correction import ADDITIVE, MULTIPLICATIVE, apply_correction, ecdf, equally_spaced_nodes, get_correction, invert, map_cdf  # noqa: F401
from .interp import interp1d_table, interp_on_quantiles_grouped, searchsorted_batched  # noqa: F401
from .quantile import grouped_nan_quantile, nan_quantile, vecquantiles  # noqa: F401
from .rank import average_rank, pct_rank, rank_pct_rescaled  # noqa: F401
from .segment import gather_groups, grouped_mean, grouped_rank, grouped_std, scatter_back  # noqa: F401

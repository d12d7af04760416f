"""The reference's ``xsdba.options`` import path: the options of
``utils/options.py`` that the JAX package's ``options.py`` lists, and the
port's own ``DEVICE``."""

from .utils.options import (  # noqa: F401
    AS_DATASET,
    DEVICE,
    EXTRA_OUTPUT,
    EXTRACT_FLAT,
    FUSE_FOLD_CLASSES,
    OPTIONS,
    SELECTION_BACKEND,
    SELECTION_MODE,
    SELECTION_ON_TPU,
    get_option,
    set_options,
)

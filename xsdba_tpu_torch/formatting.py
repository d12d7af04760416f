"""The reference's ``xsdba.formatting`` import path."""

from .utils.formatting import (  # noqa: F401
    gen_call_string,
    merge_attributes,
    update_history,
    update_xsdba_history,
)

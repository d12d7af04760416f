from .calendar import TimeIndex, date_range, interpolate_doy_calendar, max_doy
from .container import DataArray, Dataset
from .grouper import GroupIndexes, Grouper, parse_group, period_blocks
from .options import get_option, set_options
from .units import Quantity, convert_units_to, harmonize_units, infer_sampling_units, pint2cfattrs, str2quantity, units2str

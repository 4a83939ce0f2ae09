from .synthetic import Dataset, load, make_classification, PAPER_LIKE
from .device_window import rolling_subwindow

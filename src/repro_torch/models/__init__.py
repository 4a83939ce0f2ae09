from . import linear

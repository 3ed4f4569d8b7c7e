"""Foundation layer: track-dict keys, instrument profiles, host helpers."""

from .constants import *
from .instrument import *
from .utils import *
from .io import *

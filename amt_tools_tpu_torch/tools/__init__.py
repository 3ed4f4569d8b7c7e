"""Foundation layer: track-dict keys, instrument profiles, host helpers,
I/O and visualization."""

from .constants import *
from .instrument import *
from .utils import *
from .io import *
from .visualize import *

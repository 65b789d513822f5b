"""Text frontend of the port: Russian G2P, the plain symbol map, g2p_plain.

Host-side pure Python, a copy of the JAX package's frontend so that the
port imports nothing from it."""

from .frontend import g2p_plain, load_dictionary
from .g2p import convert
from .symbols import BASE_SYMBOLS, PHONES, plain_symbol_map

"""Text frontend of the port: Russian G2P, the plain and multistream symbol
maps, g2p_plain, g2p_multistream, a BERT WordPiece tokenizer, and the
GPT-SoVITS cleaner (Russian and English G2P, the 351-symbol table).

Host-side pure Python, a copy of the JAX package's frontend so that the
port imports nothing from it."""

from .cleaner import Cleaner, gpt_sovits_symbol_map, gpt_sovits_symbols
from .frontend import add_word_positions, g2p_multistream, g2p_plain, load_dictionary
from .g2p import convert
from .symbols import BASE_SYMBOLS, PHONES, multistream_symbol_map, plain_symbol_map
from .wordpiece import WordPieceTokenizer

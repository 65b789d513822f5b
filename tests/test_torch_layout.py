"""The port's layout conversion round trip: ``from_port_layout(to_port_layout(t),
linears) == t`` (every leaf: path, shape and value) for each tree the port
initialises, with that kind of tree's Linears, from the port's numpy inits at
small widths, and for the committed speaker-encoder artifact; the StableTTS
tree also through its fused qkv
(``stabletts.bundle_layout(stabletts.port_layout(t)) == t``). No JAX here:
the inits' structures are held to the JAX package's in the trainers' tests
(Whisper's in tests/test_torch_whisper.py).
"""

import numpy as np
import pytest

from vosk_tts_tpu_torch.models import stabletts, vits2
from vosk_tts_tpu_torch.models.bert import BertConfig
from vosk_tts_tpu_torch.models.gpt_sovits import ARConfig, SoVITSConfig
from vosk_tts_tpu_torch.models.hubert import HubertConfig
from vosk_tts_tpu_torch.models.quickvc import QuickVCConfig
from vosk_tts_tpu_torch.models.wavlm import WavLMConfig
from vosk_tts_tpu_torch.models.whisper import WhisperEncConfig
from vosk_tts_tpu_torch.eval import speaker_train
from vosk_tts_tpu_torch.utils import params as P
from vosk_tts_tpu_torch.utils.checkpoint import _flatten

# the shipped VITS2 flags (pre_conv2 flows, SDP, mb_istft, speaker-conditioned
# encoder) at small widths
VITS2 = dict(n_vocab=20, spec_channels=80, segment_size=8, inter_channels=32, hidden_channels=32,
             filter_channels=64, n_layers=2, upsample_initial_channel=64, n_speakers=4,
             gin_channels=16, n_flows=2, posterior_wn_layers=4)
QUICKVC = dict(spec_channels=65, segment_size=8, inter_channels=16, hidden_channels=16, ssl_dim=8,
               gin_channels=16, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
               upsample_rates=(2,), upsample_initial_channel=32, upsample_kernel_sizes=(4,),
               n_mel_channels=20)
MATCHA = dict(n_spks=2, spk_emb_dim=8, hidden_channels=32, filter_channels=64, n_heads=2,
              n_layers=2, phone_emb_dim=16, punc_emb_dim=2, bert_proj_dim=8, dec_hidden=32,
              dec_filter=64, dec_layers=2, dec_heads=2)
AR = dict(embedding_dim=32, hidden_dim=32, num_head=2, num_layers=2, vocab_size=17,
          phoneme_vocab_size=12, bert_dim=8, eos=16)
SOVITS = dict(spec_channels=33, segment_size=4, inter_channels=8, hidden_channels=16,
              filter_channels=32, n_layers=2, resblock_kernel_sizes=(3,),
              resblock_dilation_sizes=((1, 3),), upsample_rates=(2, 2),
              upsample_initial_channel=16, upsample_kernel_sizes=(4, 4), gin_channels=8,
              ssl_dim=12, n_codes=10, n_symbols=20, mrte_hidden=16, style_hidden=8)
BERT = dict(vocab_size=30, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=32, max_position_embeddings=20)
HUBERT = dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=2, intermediate_size=32,
              conv_dim=(8, 8), conv_stride=(5, 2), conv_kernel=(10, 3),
              num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=4)
WAVLM = dict(HUBERT, num_buckets=16, max_bucket_distance=32)
WHISPER = dict(num_mel_bins=8, d_model=16, encoder_layers=2, encoder_attention_heads=2,
               encoder_ffn_dim=32, max_source_positions=20)


def _matcha():
    return P.perturb_matcha_zero_init(P.matcha_init(stabletts.StableTTSConfig(**MATCHA), 0), 1)


# name -> (the tree, its Linears)
TREES = {
    "synthesizer": (lambda: P.perturb_zero_init(P.synthesizer_init(vits2.VITS2Config(**VITS2), 0),
                                                1), P.LINEARS),
    "mpmsd": (lambda: P.mpmsd_init(2, (2, 3), (256,)), P.LINEARS),
    "duration_disc": (lambda: P.duration_disc_init(3, 32, 32, 3), P.LINEARS),
    "mpd": (lambda: P.mpd_init(4), P.LINEARS),
    "quickvc": (lambda: P.quickvc_init(QuickVCConfig(**QUICKVC), 5), P.LINEARS),
    "matcha": (_matcha, P.LINEARS),
    "ar": (lambda: P.ar_init(ARConfig(**AR), 6), P.AR_LINEARS),
    "sovits": (lambda: P.sovits_init(SoVITSConfig(**SOVITS), 7), P.SOVITS_LINEARS),
    "bert": (lambda: P.bert_init(BertConfig(**BERT), 8), P.BERT_LINEARS),
    "hubert": (lambda: P.hubert_init(HubertConfig(**HUBERT), 9), P.HUBERT_LINEARS),
    "wavlm": (lambda: P.wavlm_init(WavLMConfig(**WAVLM), 10), P.WAVLM_LINEARS),
    # its pre is a 1x1 conv (1, 3 x 16, 8): under LINEARS it comes back as one
    "wavlm_disc": (lambda: P.wavlm_disc_init(11, 16, 3, 8), P.LINEARS),
    "whisper": (lambda: P.whisper_init(WhisperEncConfig(**WHISPER), 12), P.WHISPER_LINEARS),
    # the committed GE2E speaker encoder (its scalar w and b keep their layout)
    "speaker_encoder": (lambda: speaker_train.load_artifact()["params"], P.LINEARS),
}


def _assert_same(got, want):
    got, want = _flatten(got), _flatten(want)
    assert list(got) == list(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, (path, got[path].shape, w.shape)
        np.testing.assert_array_equal(got[path], w, err_msg=path)


@pytest.mark.parametrize("name", list(TREES))
def test_round_trip(name):
    make, linears = TREES[name]
    tree = make()
    port = P.to_port_layout(tree)
    _assert_same(P.from_port_layout(port, linears), tree)


def test_linears_differ_between_trees():
    """One name, two layouts: the VITS2 set restores a BERT ``q`` as a 1x1
    conv (VITS2's attention) and the BERT set as a Linear; with another
    tree's set the AR's projections come back as (1, I, O), and with no set
    the call is refused."""
    bert = P.bert_init(BertConfig(**BERT), 8)
    port = P.to_port_layout(bert)
    assert P.from_port_layout(port, P.LINEARS)["layers"][0]["q"]["w"].shape == (1, 16, 16)
    assert P.from_port_layout(port, P.BERT_LINEARS)["layers"][0]["q"]["w"].shape == (16, 16)
    ar = P.to_port_layout(P.ar_init(ARConfig(**AR), 6))
    assert P.from_port_layout(ar, P.LINEARS)["layers"][0]["qkv"]["w"].shape == (1, 32, 96)
    with pytest.raises(TypeError):
        P.from_port_layout(ar)


def test_wavlm_leaves_keep_their_layout():
    """WavLM's per-head tables are not ``"w"`` and keep their layout; its
    Linears become (O, I); the discriminator's ``pre`` 1x1 conv (O, I), and
    restored as (1, I, O), never as a Linear."""
    port = P.to_port_layout(P.wavlm_init(WavLMConfig(**WAVLM), 10))
    assert port["layers"][0]["gru_const"].shape == (1, 2, 1, 1)
    assert port["rel_attn_embed"].shape == (16, 2)
    assert port["layers"][0]["gru_lin"]["w"].shape == (8, 8)  # (8, head_dim)
    assert port["fp"]["w"].shape == (16, 8)
    disc = P.to_port_layout(P.wavlm_disc_init(11, 16, 3, 8))
    assert disc["pre"]["w"].shape == (8, 48)
    assert P.from_port_layout(disc, P.LINEARS)["pre"]["w"].shape == (1, 48, 8)
    assert "pre" not in P.WAVLM_LINEARS


def test_matcha_fused_qkv_round_trip():
    tree = _matcha()
    port = stabletts.port_layout(tree)
    blk = port["decoder"]["blocks"][0]["dit"]["attn"]
    assert set(blk) == {"qkv", "o"} and blk["qkv"]["w"].shape == (3 * 32, 32)
    _assert_same(stabletts.bundle_layout(port), tree)


def test_layouts_differ_where_they_should():
    """The round trip is not the identity by accident: the LSTM weights, the
    Linears and the fused qkv change shape in the port's layout."""
    q = P.to_port_layout(TREES["quickvc"][0]())
    assert q["enc_spk"]["lstm"][1]["w_ih"].shape == (64, 16)  # (4H, I)
    assert q["enc_spk"]["linear"]["w"].shape == (16, 16)
    m = stabletts.port_layout(_matcha())
    assert m["decoder"]["time_mlp"]["l1"]["w"].shape == (64, 32)  # (O, I)
    assert m["text_encoder"]["bert_proj"]["w"].shape == (8, 768)

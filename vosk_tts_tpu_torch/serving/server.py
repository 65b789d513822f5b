"""gRPC synthesis server: wire-compatible with the reference
(server/tts_server.py), with chunked streaming and batching on the card.

    python -m vosk_tts_tpu_torch.serving.server

Env config (the reference's variables):
  VOSK_SERVER_INTERFACE (default 0.0.0.0), VOSK_SERVER_PORT (5001),
  VOSK_SERVER_THREADS (8), VOSK_MODEL_PATH / VOSK_TPU_MODEL_PATH.
The model loads on the card (``Model``'s default) and the server fails to
start where CUDA is missing.

Differences from the reference:
  * responses stream in ~0.5 s PCM chunks instead of one chunk;
  * concurrent requests are batched onto the device (serving/batcher.py).
"""

from __future__ import annotations

import logging
import os
import re
import struct
from concurrent import futures

import grpc

from . import proto
from .batcher import BatchSynthesizer
from ..api import Model
from ..utils.precision import full_float32

CHUNK_SECONDS = 0.5


def _wav_header(n_samples: int, sample_rate: int) -> bytes:
    data_size = n_samples * 2
    return b"RIFF" + struct.pack("<I", 36 + data_size) + b"WAVEfmt " + struct.pack(
        "<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16
    ) + b"data" + struct.pack("<I", data_size)


class SynthesizerServicer:
    def __init__(self, model: Model, max_batch: int = 8):
        self.model = model
        self.batcher = BatchSynthesizer(model, max_batch=max_batch)

    def UtteranceSynthesis(self, request, context):
        """Serves every bundle kind the port loads (plain vits2 and
        multistream_v1/2/3) through the batcher (reference
        tts_server.py:42-54). Hints: speaker_id, speech_rate; output: a WAV
        container unless raw PCM is asked for."""
        speaker_id, speech_rate = 0, None
        for hint in request.hints:
            if hint.WhichOneof("Hint") == "speaker_id":
                speaker_id = hint.speaker_id
            elif hint.WhichOneof("Hint") == "speech_rate":
                speech_rate = hint.speech_rate

        text = re.sub("—", "-", request.text.strip())
        audio = self.batcher.submit_text(text, sid=speaker_id, speech_rate=speech_rate).result()

        spec = request.output_audio_spec
        want_wav = (spec.WhichOneof("AudioFormat") in (None, "container_audio")
                    and spec.container_audio.container_audio_type in (0, 1))
        if want_wav:
            yield proto.UtteranceSynthesisResponse(
                audio_chunk=proto.AudioChunk(data=_wav_header(len(audio), self.model.sample_rate)))
        chunk = max(1, int(CHUNK_SECONDS * self.model.sample_rate))
        for off in range(0, len(audio), chunk):
            yield proto.UtteranceSynthesisResponse(
                audio_chunk=proto.AudioChunk(data=audio[off: off + chunk].tobytes()))


def make_server(model: Model, interface: str = "0.0.0.0", port: int = 5001, threads: int = 8):
    """A grpc.server (not started) with the Synthesizer service; returns
    (server, servicer, bound port). Close ``servicer.batcher`` after
    stopping the server."""
    servicer = SynthesizerServicer(model)
    handler = grpc.method_handlers_generic_handler(
        proto.SERVICE_NAME,
        {proto.METHOD: grpc.unary_stream_rpc_method_handler(
            servicer.UtteranceSynthesis,
            request_deserializer=proto.UtteranceSynthesisRequest.FromString,
            response_serializer=proto.UtteranceSynthesisResponse.SerializeToString)})
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=threads))
    server.add_generic_rpc_handlers((handler,))
    bound_port = server.add_insecure_port(f"{interface}:{port}")
    return server, servicer, bound_port


def serve():
    full_float32()
    logging.basicConfig(level=logging.INFO)
    interface = os.environ.get("VOSK_SERVER_INTERFACE", "0.0.0.0")
    port = int(os.environ.get("VOSK_SERVER_PORT", 5001))
    threads = int(os.environ.get("VOSK_SERVER_THREADS", 8))
    model_path = os.environ.get("VOSK_TPU_MODEL_PATH") or os.environ.get("VOSK_MODEL_PATH")

    model = Model(model_path=model_path)
    server, servicer, bound = make_server(model, interface, port, threads)
    logging.info("Listening on %s:%d (%s)", interface, bound, model.device)
    server.start()
    try:
        server.wait_for_termination()
    finally:
        servicer.batcher.close()


if __name__ == "__main__":
    serve()

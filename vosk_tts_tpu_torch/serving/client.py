"""Blocking gRPC client (the reference server/tts_client.py).

    python -m vosk_tts_tpu_torch.serving.client --server localhost:5001 \
        --input "Привет мир!" --output out.wav
"""

from __future__ import annotations

import argparse

import grpc

from . import proto


class SynthesizerClient:
    def __init__(self, target: str = "localhost:5001"):
        self.channel = grpc.insecure_channel(target)
        self._call = self.channel.unary_stream(
            f"/{proto.SERVICE_NAME}/{proto.METHOD}",
            request_serializer=proto.UtteranceSynthesisRequest.SerializeToString,
            response_deserializer=proto.UtteranceSynthesisResponse.FromString,
        )

    def synthesize(self, text: str, speaker_id: int = 0, speech_rate: float = 1.0,
                   timeout: float = 300.0) -> bytes:
        """The streamed chunks joined: a WAV file's bytes by default."""
        req = proto.UtteranceSynthesisRequest(text=text)
        req.hints.add(speaker_id=speaker_id)
        req.hints.add(speech_rate=speech_rate)
        return b"".join(resp.audio_chunk.data for resp in self._call(req, timeout=timeout))

    def close(self):
        self.channel.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="localhost:5001")
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", default="out.wav")
    ap.add_argument("--speaker", type=int, default=0)
    args = ap.parse_args(argv)
    client = SynthesizerClient(args.server)
    try:
        data = client.synthesize(args.input, args.speaker)
    finally:
        client.close()
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"wrote {len(data)} bytes to {args.output}")


if __name__ == "__main__":
    main()

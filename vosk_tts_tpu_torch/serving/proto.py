"""Runtime protobuf message classes for the TTS service, built without
``protoc``: the ``FileDescriptorProto`` of tts_service.proto is written out
below with ``descriptor_pb2`` (the same package, messages, fields, numbers,
types, oneofs and enums, and the json names protoc derives), added to a
private descriptor pool, and the classes come from ``message_factory``.
The bytes on the wire are those of any other implementation of the
schema."""

from __future__ import annotations

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

SERVICE_NAME = "vosk.tts.Synthesizer"
METHOD = "UtteranceSynthesis"

_F = descriptor_pb2.FieldDescriptorProto
_OPT, _REP = _F.LABEL_OPTIONAL, _F.LABEL_REPEATED

# message -> (fields as (name, number, type, message or enum type, oneof index, label),
#             oneof names, nested enums as {name: value names in number order})
_MESSAGES = {
    "AudioFormatOptions": (
        [("raw_audio", 1, _F.TYPE_MESSAGE, "RawAudio", 0, _OPT),
         ("container_audio", 2, _F.TYPE_MESSAGE, "ContainerAudio", 0, _OPT)],
        ["AudioFormat"], {}),
    "RawAudio": (
        [("audio_encoding", 1, _F.TYPE_ENUM, "RawAudio.AudioEncoding", None, _OPT),
         ("sample_rate_hertz", 2, _F.TYPE_INT64, None, None, _OPT)],
        [], {"AudioEncoding": ["AUDIO_ENCODING_UNSPECIFIED", "LINEAR16_PCM"]}),
    "ContainerAudio": (
        [("container_audio_type", 1, _F.TYPE_ENUM, "ContainerAudio.ContainerAudioType", None,
          _OPT)],
        [], {"ContainerAudioType": ["CONTAINER_AUDIO_TYPE_UNSPECIFIED", "WAV", "OGG_OPUS",
                                    "MP3"]}),
    "UtteranceSynthesisResponse": (
        [("audio_chunk", 1, _F.TYPE_MESSAGE, "AudioChunk", None, _OPT)], [], {}),
    "AudioChunk": ([("data", 1, _F.TYPE_BYTES, None, None, _OPT)], [], {}),
    "Hints": (
        [("speaker_id", 1, _F.TYPE_INT64, None, 0, _OPT),
         ("speech_rate", 2, _F.TYPE_DOUBLE, None, 0, _OPT),
         ("role", 3, _F.TYPE_STRING, None, 0, _OPT)],
        ["Hint"], {}),
    "UtteranceSynthesisRequest": (
        [("model", 1, _F.TYPE_STRING, None, None, _OPT),
         ("text", 2, _F.TYPE_STRING, None, 0, _OPT),
         ("hints", 3, _F.TYPE_MESSAGE, "Hints", None, _REP),
         ("output_audio_spec", 4, _F.TYPE_MESSAGE, "AudioFormatOptions", None, _OPT)],
        ["Utterance"], {}),
}


def _json_name(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(part[:1].upper() + part[1:] for part in rest)


def file_descriptor() -> descriptor_pb2.FileDescriptorProto:
    """tts_service.proto as a FileDescriptorProto."""
    fd = descriptor_pb2.FileDescriptorProto(name="tts_service.proto", package="vosk.tts",
                                            syntax="proto3")
    for msg_name, (fields, oneofs, enums) in _MESSAGES.items():
        msg = fd.message_type.add(name=msg_name)
        for name, number, ftype, type_name, oneof, label in fields:
            f = msg.field.add(name=name, number=number, label=label, type=ftype,
                              json_name=_json_name(name))
            if type_name is not None:
                f.type_name = f".vosk.tts.{type_name}"
            if oneof is not None:
                f.oneof_index = oneof
        for enum_name, values in enums.items():
            enum = msg.enum_type.add(name=enum_name)
            for number, value in enumerate(values):
                enum.value.add(name=value, number=number)
        for oneof in oneofs:
            msg.oneof_decl.add(name=oneof)
    method = fd.service.add(name="Synthesizer").method.add(
        name=METHOD, input_type=".vosk.tts.UtteranceSynthesisRequest",
        output_type=".vosk.tts.UtteranceSynthesisResponse", server_streaming=True)
    method.options.SetInParent()
    return fd


_pool = descriptor_pool.DescriptorPool()
_pool.AddSerializedFile(file_descriptor().SerializeToString())


def _msg(name: str):
    return message_factory.GetMessageClass(_pool.FindMessageTypeByName(f"vosk.tts.{name}"))


UtteranceSynthesisRequest = _msg("UtteranceSynthesisRequest")
UtteranceSynthesisResponse = _msg("UtteranceSynthesisResponse")
AudioChunk = _msg("AudioChunk")
Hints = _msg("Hints")
AudioFormatOptions = _msg("AudioFormatOptions")
RawAudio = _msg("RawAudio")
ContainerAudio = _msg("ContainerAudio")

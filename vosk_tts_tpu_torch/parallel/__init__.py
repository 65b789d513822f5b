"""Data- and tensor-parallel training and serving over ``torch.distributed``
(vosk_tts_tpu/parallel/): the process group and the (data, model) grid
(mesh.py), the collectives of the global-batch step, and the
tensor-parallel generator (tp.py)."""

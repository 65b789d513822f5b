"""Training of the port (VITS2 GAN training; vosk_tts_tpu/train/)."""

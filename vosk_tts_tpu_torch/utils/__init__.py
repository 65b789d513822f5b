"""Bundle I/O, the weight carrier and the CUDA build."""

"""Tensor ops (DCT, masking, bit-packing) and host codecs of the port."""

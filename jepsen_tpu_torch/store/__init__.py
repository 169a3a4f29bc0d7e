"""The part of jepsen_tpu/store that the port's checkpoints use: the
CRC-framed record format (format.py). Run directories, their layout
and the history log writer are not ported."""

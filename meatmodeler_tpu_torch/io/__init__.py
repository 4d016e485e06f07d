"""Host I/O for the port: the synthetic renderer's torch backend. Video
decoding and PLY files reuse ``meatmodeler_tpu.io.video`` / ``io.ply``."""

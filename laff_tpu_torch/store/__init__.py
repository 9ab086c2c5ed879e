from .bigfile import BigFile, StreamFile, txt2bin, write_bigfile

__all__ = ["BigFile", "StreamFile", "txt2bin", "write_bigfile"]

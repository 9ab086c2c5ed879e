from .bigfile import BigFile, txt2bin, write_bigfile

__all__ = ["BigFile", "txt2bin", "write_bigfile"]

from .bigfile import BigFile, write_bigfile

__all__ = ["BigFile", "write_bigfile"]

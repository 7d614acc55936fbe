"""Netpbm image IO: PBM/PGM/PPM (P1-P6) and PAM (P7) to/from numpy arrays.

Reference: GPy/util/netpbmfile.py (331 LoC, vendored third-party reader used
by util/datasets.py image loaders). Fresh implementation of the public
netpbm format spec (netpbm.sourceforge.net/doc): ASCII (P1-P3) and binary
(P4-P6) maps with 8/16-bit samples, plus the P7 PAM header. Counterpart of
gpy_tpu/util/netpbmfile.py, numpy only.
"""
from __future__ import annotations

import re

import numpy as np

__all__ = ["imread", "imsave", "NetpbmFile"]

_ASCII = {b"P1": 1, b"P2": 1, b"P3": 3}
_BINARY = {b"P4": 1, b"P5": 1, b"P6": 3}


def _read_header_tokens(data, count):
    """Yield `count` whitespace-separated tokens after the magic, skipping
    '#' comments; returns (tokens, offset past the single whitespace that
    terminates the header)."""
    tokens = []
    pos = 2  # past magic
    while len(tokens) < count:
        m = re.compile(rb"\s*(#[^\n\r]*[\n\r]|\S+)").match(data, pos)
        if m is None:
            raise ValueError("truncated netpbm header")
        tok = m.group(1)
        pos = m.end()
        if not tok.startswith(b"#"):
            tokens.append(int(tok))
    # binary formats: exactly one whitespace char terminates the header
    return tokens, pos + 1


class NetpbmFile:
    """Decoded netpbm image. Use `asarray()` for the pixel data."""

    def __init__(self, arg=None):
        if arg is None:
            self._data = None
            return
        if isinstance(arg, np.ndarray):
            self._from_array(arg)
        elif isinstance(arg, (bytes, bytearray)):
            self._from_bytes(bytes(arg))
        else:  # path or file handle
            if hasattr(arg, "read"):
                data = arg.read()
            else:
                with open(arg, "rb") as fh:
                    data = fh.read()
            self._from_bytes(data)

    # --- decoding -----------------------------------------------------------
    def _from_bytes(self, data):
        magic = data[:2]
        if magic == b"P7":
            self._from_pam(data)
            return
        if magic in _ASCII:
            depth = _ASCII[magic]
            nhead = 2 if magic == b"P1" else 3
            toks, _ = _read_header_tokens(data, nhead)
            width, height = toks[0], toks[1]
            self.maxval = 1 if magic == b"P1" else toks[2]
            # ASCII samples: all ints after the header
            text = re.sub(rb"#[^\n\r]*", b"", data[2:])
            if magic == b"P1":  # no maxval token; 0/1 digits may also be unspaced
                flat = re.sub(rb"[^01]", b"", b"".join(text.split()[2:]))
                vals = np.frombuffer(flat, dtype=np.uint8) - ord("0")
            else:
                vals = np.array(text.split()[nhead:],
                                dtype=np.uint16 if self.maxval > 255 else np.uint8)
            self._finish(vals, height, width, depth)
        elif magic in _BINARY:
            depth = _BINARY[magic]
            nhead = 2 if magic == b"P4" else 3
            toks, offset = _read_header_tokens(data, nhead)
            width, height = toks[0], toks[1]
            self.maxval = 1 if magic == b"P4" else toks[2]
            if magic == b"P4":
                rowbytes = (width + 7) // 8
                raw = np.frombuffer(data, dtype=np.uint8, count=rowbytes * height, offset=offset)
                bits = np.unpackbits(raw.reshape(height, rowbytes), axis=1)[:, :width]
                self._finish(bits.ravel(), height, width, 1)
            else:
                dtype = ">u2" if self.maxval > 255 else np.uint8
                n = width * height * depth
                vals = np.frombuffer(data, dtype=dtype, count=n, offset=offset)
                self._finish(vals, height, width, depth)
        else:
            raise ValueError(f"not a netpbm file (magic {magic!r})")

    def _from_pam(self, data):
        header_end = data.find(b"ENDHDR\n")
        if header_end < 0:
            raise ValueError("truncated PAM header")
        fields = {}
        for line in data[2:header_end].splitlines():
            line = line.split(b"#")[0].strip()
            if line:
                key, _, val = line.partition(b" ")
                fields[key.decode()] = val.strip().decode()
        width = int(fields["WIDTH"])
        height = int(fields["HEIGHT"])
        depth = int(fields["DEPTH"])
        self.maxval = int(fields["MAXVAL"])
        dtype = ">u2" if self.maxval > 255 else np.uint8
        vals = np.frombuffer(data, dtype=dtype, count=width * height * depth,
                             offset=header_end + len(b"ENDHDR\n"))
        self._finish(vals, height, width, depth)

    def _finish(self, vals, height, width, depth):
        dtype = np.uint16 if self.maxval > 255 else np.uint8
        arr = np.asarray(vals, dtype=dtype)
        shape = (height, width, depth) if depth > 1 else (height, width)
        self._data = arr.reshape(shape)
        self.width, self.height, self.depth = width, height, depth

    def _from_array(self, arr):
        arr = np.asarray(arr)
        if arr.ndim == 2:
            depth = 1
        elif arr.ndim == 3 and arr.shape[2] in (1, 3):
            depth = arr.shape[2]
        else:
            raise ValueError(f"cannot encode array of shape {arr.shape}")
        self.maxval = 65535 if arr.dtype.itemsize > 1 else 255
        self._data = arr
        self.height, self.width, self.depth = arr.shape[0], arr.shape[1], depth

    # --- public API -----------------------------------------------------------
    def asarray(self, copy=True):
        return self._data.copy() if copy else self._data

    def write(self, arg, maxval=None, pam=False):
        data = np.ascontiguousarray(self._data)
        maxval = self.maxval if maxval is None else maxval
        wide = maxval > 255
        body = data.astype(">u2" if wide else np.uint8).tobytes()
        if pam:
            tupltype = b"RGB" if self.depth == 3 else b"GRAYSCALE"
            header = (b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n"
                      b"TUPLTYPE %s\nENDHDR\n"
                      % (self.width, self.height, self.depth, maxval, tupltype))
        else:
            magic = b"P6" if self.depth == 3 else b"P5"
            header = b"%s %d %d %d\n" % (magic, self.width, self.height, maxval)
        payload = header + body
        if hasattr(arg, "write"):
            arg.write(payload)
        else:
            with open(arg, "wb") as fh:
                fh.write(payload)

    def close(self):
        pass

    def __str__(self):
        return f"NetpbmFile({self.width}x{self.height}x{self.depth}, maxval={self.maxval})"


def imread(filename, *args, **kwargs):
    """Read a PBM/PGM/PPM/PAM image into a numpy array."""
    return NetpbmFile(filename).asarray()


def imsave(filename, data, maxval=None, pam=False):
    """Save a numpy array as binary PGM/PPM (or PAM with pam=True)."""
    f = NetpbmFile(np.asarray(data))
    f.write(filename, maxval=maxval, pam=pam)

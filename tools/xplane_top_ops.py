#!/usr/bin/env python
"""Minimal XSpace (.xplane.pb) parser: top self-time ops per GPU device plane
(`/device:GPU:N`).

The full xprof/tensorboard converters in this image are protobuf-version
incompatible, so this decodes the protobuf wire format directly (no
generated code).  Schema subset (tsl/profiler/protobuf/xplane.proto):

  XSpace   { repeated XPlane planes = 1; }
  XPlane   { int64 id=1; string name=2; repeated XLine lines=3;
             map<int64,XEventMetadata> event_metadata=4; }
  XLine    { string name=2; repeated XEvent events=4; }
  XEvent   { int64 metadata_id=1; int64 offset_ps=2; int64 duration_ps=3; }
  XEventMetadata { int64 id=1; string name=2; string display_name=4; }

Usage: python tools/xplane_top_ops.py <file.xplane.pb> [top_n]
"""

import struct
import sys
from collections import defaultdict


def read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf):
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:          # varint
            val, pos = read_varint(buf, pos)
        elif wt == 1:        # 64-bit
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wt == 2:        # length-delimited
            ln, pos = read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:        # 32-bit
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"wire type {wt}")
        yield field, wt, val


def parse_event_metadata(buf):
    mid, name, disp = 0, "", ""
    for f, _, v in iter_fields(buf):
        if f == 1:
            mid = v
        elif f == 2:
            name = v.decode(errors="replace")
        elif f == 4:
            disp = v.decode(errors="replace")
    return mid, (disp or name)


def parse_plane(buf):
    name = ""
    lines = []
    meta = {}
    for f, _, v in iter_fields(buf):
        if f == 2:
            name = v.decode(errors="replace")
        elif f == 3:
            lines.append(v)
        elif f == 4:  # map entry { key=1; value=2(XEventMetadata) }
            key, md = 0, b""
            for f2, _, v2 in iter_fields(v):
                if f2 == 1:
                    key = v2
                elif f2 == 2:
                    md = v2
            mid, mname = parse_event_metadata(md)
            meta[key or mid] = mname
    return name, lines, meta


def plane_op_times(lines, meta):
    """Aggregate total duration_ps by event metadata name per line."""
    per_line = {}
    for lbuf in lines:
        lname = ""
        times = defaultdict(int)
        counts = defaultdict(int)
        for f, _, v in iter_fields(lbuf):
            if f == 2:
                lname = v.decode(errors="replace")
            elif f == 4:
                mid = dur = 0
                for f2, _, v2 in iter_fields(v):
                    if f2 == 1:
                        mid = v2
                    elif f2 == 3:
                        dur = v2
                nm = meta.get(mid, f"#{mid}")
                times[nm] += dur
                counts[nm] += 1
        per_line[lname or f"line{len(per_line)}"] = (times, counts)
    return per_line


def main():
    path = sys.argv[1]
    top_n = int(sys.argv[2]) if len(sys.argv) > 2 else 25
    buf = open(path, "rb").read()
    for f, _, v in iter_fields(buf):
        if f != 1:
            continue
        pname, lines, meta = parse_plane(v)
        if not pname.startswith("/device:GPU:"):
            continue
        per_line = plane_op_times(lines, meta)
        for lname, (times, counts) in per_line.items():
            total = sum(times.values())
            if not total:
                continue
            print(f"\n== plane '{pname}' line '{lname}' "
                  f"total {total/1e9:.3f} ms ==")
            for nm, t in sorted(times.items(), key=lambda kv: -kv[1])[:top_n]:
                print(f"  {t/1e9:9.3f} ms  {t/total*100:5.1f}%  "
                      f"x{counts[nm]:<6d} {nm[:110]}")


if __name__ == "__main__":
    main()

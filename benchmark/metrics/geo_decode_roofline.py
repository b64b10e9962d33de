"""geo_decode_roofline: the traced requests' volume decodes' bound time
(frozen operations and bytes of the queries each decode needs: its coarse
points and its chosen blocks' points, with the K/V and weights read once a
decode call) over the device time of the kernels launched inside the decode
calls (ops/geo_decoder.py's streamed chain, csrc/geo_decode.cu and kernel
1), in %. The calls also decode the padding of each pass's last chunk:
that counts as time, not as work."""

from benchmark import flops


def read(run):
    if run.trace is None or not run.traced_counts.get("volume_decode"):
        return None
    device_s = run.trace.device_s.get("geo_decode", 0.0)
    if device_s <= 0.0:
        return None
    vae = run.config["vae"]
    bound = sum(flops.bound_s(q * flops.geo_query_flops(vae),
                              flops.geo_decode_bytes(vae, q, calls),
                              flops.PEAK_BF16)
                for q, calls in run.traced_counts["volume_decode"])
    return 100.0 * bound / device_s

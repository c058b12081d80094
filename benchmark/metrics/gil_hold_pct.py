"""gil_hold_pct (%): the share of the lanes' parse seconds spent outside
the host library's GIL-releasing calls (centropy.gil_meter, on in the
traced window only): the part of the parse that serialises on the GIL."""


def read(w):
    if w.parse_released_s is None or not w.host_parse_s > 0:
        return None
    return 100.0 * (w.host_parse_s - w.parse_released_s) / w.host_parse_s

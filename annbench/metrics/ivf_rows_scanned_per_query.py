"""Rows an IVF query scans: n_probes times the layout's slot (rows per
probe unit, padding included)."""


def read(record: dict):
    facts = record["facts"]
    if facts["kind"] != "ivf":
        return None
    return facts["n_probes"] * facts["slot"]

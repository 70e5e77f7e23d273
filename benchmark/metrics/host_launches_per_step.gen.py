"""Denoiser: host launch calls (runtime and driver launch API, graph
launches) per denoiser call, over the traced job's sampling."""


def read(run):
    tr = run.get("traced", {})
    sess, calls = tr.get("sample_session"), tr.get("calls")
    if sess is None or not calls:
        return None
    return len(sess.launches) / calls

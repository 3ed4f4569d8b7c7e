"""Audio-seconds of every clip whose notes came back to the host in the
window, over the window's seconds (host clock)."""


def read(record):
    if 'audio_s' not in record.work or record.window_s <= 0:
        return None

    return record.work['audio_s'] / record.window_s

"""Real-time microphone visualization demo.

The port's twin of ``examples/inference/microphone.py``: capture audio from
the microphone on a background thread, display the rolling waveform and
its Mel spectrogram (computed on the card unless ``device`` is ``cpu``) in
real time. Requires the optional ``sounddevice`` package (PortAudio);
without it the stream raises a clear error.

Run: ``python microphone.py [device]``  (press Ctrl+C or ENTER to stop)
"""

import os
import sys

# Runnable without installation: resolve the repo root
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..', '..'))

from amt_tools_tpu_torch.features import MelSpec, MicrophoneStream
from amt_tools_tpu_torch.features.stream import _HAVE_PYNPUT
from amt_tools_tpu_torch.tools.visualize import (WaveformVisualizer,
                                                 TFRVisualizer)


def main(device=None):
    sample_rate = 16000
    hop_length = 512

    # Feature module for the spectrogram display
    mel = MelSpec(sample_rate=sample_rate, hop_length=hop_length, n_mels=96)

    # Microphone capture with a buffer long enough for one full frame
    stream = MicrophoneStream(mel, frame_buffer_size=1,
                              enter_to_stop=_HAVE_PYNPUT,
                              feature_device=device)

    # Rolling visualizers (throttled to every 4th frame to keep up)
    waveform_viz = WaveformVisualizer(sample_rate=sample_rate,
                                      buffer_size=4 * sample_rate,
                                      plot_frequency=4)
    tfr_viz = TFRVisualizer(sample_rate=sample_rate, hop_length=hop_length,
                            num_bins=96, buffer_size=256, plot_frequency=4)

    stream.start_streaming()
    print('Streaming from microphone... press ENTER (or Ctrl+C) to stop.')

    try:
        while not stream.query_finished():
            features = stream.extract_frame_features()
            if features is None:
                break

            # Update the displays with the newest hop of data
            with stream._lock:
                samples = stream.audio_buffer[-hop_length:].copy()
            waveform_viz.update(samples)
            tfr_viz.update(features.squeeze(0))
    except KeyboardInterrupt:
        pass
    finally:
        stream.stop_streaming()
        waveform_viz.close()
        tfr_viz.close()


if __name__ == '__main__':
    main(*sys.argv[1:2])

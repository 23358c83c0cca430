"""Live audio capture block, the port of ``bifrost_tpu/blocks/audio.py``
(reference: python/bifrost/blocks/audio.py,
portaudio.py).

The PortAudio binding lives in :mod:`bifrost_tpu_torch.io.portaudio` (ctypes,
no compiled extension).  The block is fully implemented; the only gate
is libportaudio's presence on the host (the binding is injectable for
tests — io.portaudio.set_library)."""

from __future__ import annotations

from ..pipeline import SourceBlock
from ..io import portaudio as audio

__all__ = ['AudioSourceBlock', 'read_audio', 'HAVE_PORTAUDIO']

HAVE_PORTAUDIO = audio.available()


class AudioSourceBlock(SourceBlock):
    """Stream gulps from audio input devices; one sequence per device
    (reference: blocks/audio.py AudioSourceBlock)."""

    reader = None

    def create_reader(self, kwargs):
        kwargs = dict(kwargs)
        kwargs.setdefault('frames_per_buffer', self.gulp_nframe)
        self.reader = audio.open(mode='r', **kwargs)
        return self.reader

    def on_sequence(self, reader, kwargs):
        return [{
            '_tensor': {
                'dtype': 'i%d' % reader.nbits,
                'shape': [-1, reader.channels],
                'labels': ['time', 'pol'],
                'scales': [[0, 1. / reader.rate], None],
                'units': ['s', None],
            },
            'frame_rate': reader.rate,
            'input_device': reader.input_device,
            'name': 'audio-%d' % id(reader),
        }]

    def on_data(self, reader, ospans):
        ospan = ospans[0]
        try:
            reader.readinto(ospan.data.as_numpy())
        except audio.PortAudioError:
            return [0]
        return [ospan.nframe]

    def stop(self):
        if self.reader is not None:
            self.reader.stop()


def read_audio(audio_kwargs, gulp_nframe, *args, **kwargs):
    """Block: capture live audio via PortAudio.  ``audio_kwargs`` is a
    list of parameter dicts (rate/channels/nbits/input_device), one
    sequence each (reference: blocks/audio.py read_audio)."""
    if not audio.available():
        raise ImportError(
            "libportaudio is not available on this host; "
            "use blocks.read_wav for audio files")
    return AudioSourceBlock(audio_kwargs, gulp_nframe, *args, **kwargs)

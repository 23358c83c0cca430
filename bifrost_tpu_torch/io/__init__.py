"""Host I/O (numpy and the standard library; the port of
``bifrost_tpu/io``).

- File formats: the SIGPROC filterbank format (:mod:`.sigproc`) and the
  GUPPI RAW block headers (:mod:`.guppi`).
- Packets: the twelve wire formats (:mod:`.packet_formats`), UDP sockets
  with ``recvmmsg``/``sendmmsg`` batching (:mod:`.udp_socket`), the
  capture engines (:mod:`.packet_capture`: the Python engine, the native
  C++ engine over a native ring, the sharded zero-copy engine, the raw
  sniffer, disk replay) and the transmit engines
  (:mod:`.packet_writer`).
- PSRDADA shared-memory rings (:mod:`.dada_shm`) and the PortAudio
  binding (:mod:`.portaudio`).
- The TCP ring bridge (:mod:`.bridge`, wire v1 and v2: credit window,
  striping, CRC, reconnect and resume) that couples a ring on one host
  to a ring on another; its pipeline blocks are
  ``blocks.bridge_sink`` / ``blocks.bridge_source``.
"""

from . import guppi, sigproc
from . import packet_formats, udp_socket, packet_capture, packet_writer
from . import dada_shm, portaudio, bridge
from .udp_socket import Address, UDPSocket
from .packet_formats import (PacketDesc, get_format, register_format,
                             FORMATS, SimpleFormat, ChipsFormat,
                             PBeamFormat, TbnFormat, DrxFormat,
                             Drx8Format, IBeamFormat, CorFormat,
                             Snap2Format, VdifFormat, TbfFormat,
                             VBeamFormat)
from .packet_capture import (PacketCaptureCallback, UDPCapture,
                             NativeUDPCapture, ShardedUDPCapture,
                             UDPSniffer, DiskReader)
from .packet_writer import (HeaderInfo, RateLimiter, UDPTransmit,
                            NativeUDPTransmit, DiskWriter)
from .dada_shm import IpcRing, DadaHDU
from .bridge import (RingSender, RingReceiver, BridgeListener,
                     BridgeProtocolError, listen, connect, connect_striped,
                     query_resume, WIRE_VERSION)

__all__ = ['guppi', 'sigproc', 'packet_formats', 'udp_socket',
           'packet_capture', 'packet_writer', 'dada_shm', 'portaudio',
           'Address', 'UDPSocket', 'PacketDesc', 'get_format',
           'register_format', 'FORMATS', 'SimpleFormat', 'ChipsFormat',
           'PBeamFormat', 'TbnFormat', 'DrxFormat', 'Drx8Format',
           'IBeamFormat', 'CorFormat', 'Snap2Format', 'VdifFormat',
           'TbfFormat', 'VBeamFormat', 'PacketCaptureCallback',
           'UDPCapture', 'NativeUDPCapture', 'ShardedUDPCapture',
           'UDPSniffer', 'DiskReader', 'HeaderInfo', 'RateLimiter',
           'UDPTransmit', 'NativeUDPTransmit', 'DiskWriter', 'IpcRing',
           'DadaHDU', 'bridge', 'RingSender', 'RingReceiver',
           'BridgeListener', 'BridgeProtocolError', 'listen', 'connect',
           'connect_striped', 'query_resume', 'WIRE_VERSION']

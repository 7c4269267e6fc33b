"""OME-XML metadata generation (ome_types-free).

Produces the OME-XML the reference patches from a template
(reference: slidevips-python/slidevips/ome_metadata.py:25-47): pixel sizes,
dtype, per-channel names, objective magnification. Embedded in the first
IFD's ImageDescription by the writer, per the OME-TIFF spec.
"""

from __future__ import annotations

from typing import Optional, Sequence
from xml.sax.saxutils import escape

_OME_TYPES = {
    "uint8": "uint8", "uint16": "uint16", "uint32": "uint32",
    "int8": "int8", "int16": "int16", "int32": "int32",
    "float32": "float", "float64": "double",
}


def build_ome_xml(size_x: int, size_y: int, channel_names: Sequence[str],
                  dtype: str = "uint8", physical_size_um: Optional[float] = None,
                  magnification: Optional[float] = None) -> str:
    n = len(channel_names)
    ome_type = _OME_TYPES[str(dtype)]
    phys = ""
    if physical_size_um:
        phys = (f' PhysicalSizeX="{physical_size_um}" PhysicalSizeXUnit="µm"'
                f' PhysicalSizeY="{physical_size_um}" PhysicalSizeYUnit="µm"')
    channels = "".join(
        f'<Channel ID="Channel:{i}" Name="{escape(str(name))}" '
        f'SamplesPerPixel="1"><LightPath/></Channel>'
        for i, name in enumerate(channel_names)
    )
    planes = "".join(
        f'<Plane TheZ="0" TheT="0" TheC="{i}"/>' for i in range(n)
    )
    instrument = ""
    objective_ref = ""
    if magnification is not None:
        instrument = (
            '<Instrument ID="Instrument:0">'
            f'<Objective ID="Objective:0" NominalMagnification="{magnification}"/>'
            "</Instrument>"
        )
        objective_ref = '<ObjectiveSettings ID="Objective:0"/>'
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06" '
        'xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" '
        'xsi:schemaLocation="http://www.openmicroscopy.org/Schemas/OME/2016-06 '
        'http://www.openmicroscopy.org/Schemas/OME/2016-06/ome.xsd">'
        f"{instrument}"
        '<Image ID="Image:0" Name="Image0">'
        f"{objective_ref}"
        f'<Pixels ID="Pixels:0" DimensionOrder="XYCZT" Type="{ome_type}" '
        f'SizeX="{size_x}" SizeY="{size_y}" SizeC="{n}" SizeZ="1" SizeT="1" '
        f'Interleaved="false"{phys}>'
        f"{channels}"
        '<TiffData/>'
        f"{planes}"
        "</Pixels></Image></OME>"
    )


def parse_channel_names(ome_xml: str) -> list:
    """Best-effort channel-name extraction from OME-XML."""
    import re

    return re.findall(r'<(?:\w+:)?Channel[^>]*\bName="([^"]*)"', ome_xml)

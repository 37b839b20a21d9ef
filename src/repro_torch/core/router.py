"""Section -> PaaS routing table (paper §4.2 step 3; own copy of the
reference's ``core/router.py``).

    (a) Personal Information section        -> Personal Information PaaS
    (b) Education section                   -> Education PaaS
    (c) Work Experience section             -> Work Experience PaaS
    (d) Work Experience + Others sections   -> Skills PaaS
    (e) Others section                      -> Functional Area PaaS
"""
from __future__ import annotations

SECTIONS = ("personal_information", "education", "work_experience", "others")

SECTION_CLASSES = {name: i for i, name in enumerate(SECTIONS)}

ROUTES: dict[str, tuple[str, ...]] = {
    "personal_information": ("personal_information",),
    "education": ("education",),
    "work_experience": ("work_experience",),
    "skills": ("work_experience", "others"),
    "functional_area": ("others",),
}


def route(sectioned: dict) -> dict:
    """sectioned: {section_name: payload-list}. Returns
    {service_name: payload-list} following the paper's fan-out map."""
    out = {}
    for svc, secs in ROUTES.items():
        merged: list = []
        for s in secs:
            merged.extend(sectioned.get(s, []))
        out[svc] = merged
    return out

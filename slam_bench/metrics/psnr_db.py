"""PSNR of the end-of-frame render of frame Q against its frame."""


def read(rec):
    return rec.get("psnr_db")

"""u8_upload_share: the share of the window's forwards whose photos crossed
to the card as uint8 bytes: the predictor's ``upload_u8`` spans over its
``upload`` spans (utils/profiling.py; one ``upload`` a forward, an
``upload_u8`` inside it where the uint8 route ran), in %.  A program with
no such route reads 0; one with no ``upload`` span reads None."""


def read(run):
    uploads = len(run.window.spans.get("upload", ()))
    if uploads == 0:
        return None
    return 100.0 * len(run.window.spans.get("upload_u8", ())) / uploads

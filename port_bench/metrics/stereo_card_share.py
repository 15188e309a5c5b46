"""stereo_card_share: the share of the window's stereo photos whose stereo
ran on the card-resident chunk (the photo sent again from the chunk's
pinned buffer, the map taken where the forward left it, the results
brought down through pinned memory without blocking): the funnel's
``stereo_on_card`` spans over its ``stereo`` spans (utils/profiling.py;
one ``stereo`` a photo, a ``stereo_on_card`` inside it on that route), in
%.  A program with no such route reads 0; one with no ``stereo`` span
reads None."""


def read(run):
    photos = len(run.window.spans.get("stereo", ()))
    if photos == 0:
        return None
    return 100.0 * len(run.window.spans.get("stereo_on_card", ())) / photos
